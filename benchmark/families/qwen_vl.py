"""The Qwen-VL family on the program's side: the port's config from the
configuration file, the weights handed to the program (the benchmark's
own float weights, quantized by the port as its runner serves them), the
prompt's image block, and the model FLOPs the mfu metrics count."""

from __future__ import annotations

from benchmark.reference import qwen_vl as ref
from benchmark.reference.common import IMAGE_SENTINEL


class Family:
    name = "qwen_vl"
    reference = ref

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.d = ref.dims(cfg)
        self.image_size = self.d["S_img"]
        self.num_image_tokens = self.d["Q"]
        self.start_id = cfg["visual"]["image_start_id"]
        self.end_id = self.start_id + 1
        # ordinary text ids lie below Qwen's special tokens
        self.text_ids = (0, min(cfg["text_vocab"], self.d["V"]))
        self.bucket = cfg["serving"]["bucket"]
        self.sound_precision = cfg["serving"]["decoder_weights"]

    def image_block(self):
        """The prompt's image span, collapsed to one sentinel between the
        framing tokens (the splice expands it to n_queries features)."""
        return [self.start_id, IMAGE_SENTINEL, self.end_id]

    def none_ids(self, ids):
        """The 'none' branch: the whole image block removed."""
        drop = (IMAGE_SENTINEL, self.start_id, self.end_id)
        return [t for t in ids if t not in drop]

    def port_config(self):
        from llava_align_tpu_torch.models.qwen import QwenConfig
        from llava_align_tpu_torch.models.qwen_vit import QwenVisionConfig
        from llava_align_tpu_torch.models.qwen_vl import QwenVLConfig

        c, v, d = self.cfg, self.cfg["visual"], self.d
        text = QwenConfig(
            vocab_size=d["V"], hidden_size=d["D"], num_layers=d["L"], num_heads=d["H"], head_dim=d["Dh"],
            intermediate_size=c["intermediate_size"], layer_norm_eps=d["eps"],
            rotary_emb_base=float(c["rotary_emb_base"]), seq_length=c["seq_length"],
            use_dynamic_ntk=c["use_dynamic_ntk"], use_logn_attn=c["use_logn_attn"], dtype=d["dtype"])
        vision = QwenVisionConfig(
            image_size=v["image_size"], patch_size=v["patch_size"], width=v["width"], num_layers=v["layers"],
            num_heads=v["heads"], mlp_ratio=v["mlp_ratio"], n_queries=v["n_queries"], output_dim=v["output_dim"],
            layer_norm_eps=d["eps"], dtype=d["vdtype"])
        return QwenVLConfig(text=text, vision=vision, image_start_id=self.start_id)

    def build(self, seed: int, device):
        """(params, port config, adapter): the benchmark's float weights,
        the decoder quantized by the port's quantize_qwen_params when the
        configuration serves int8 (as runners/qwen_pope does)."""
        from llava_align_tpu_torch.decoding.adapters import QwenVLAdapter
        from llava_align_tpu_torch.ops.quant import quantize_qwen_params

        pcfg = self.port_config()
        params = ref.make_weights(self.cfg, seed, device)
        if self.sound_precision == "int8":
            params = dict(params, qwen=quantize_qwen_params(params["qwen"]))
        elif self.sound_precision != "float":
            raise ValueError(f"decoder_weights {self.sound_precision!r}")
        return params, pcfg, QwenVLAdapter(pcfg)

    # -- model FLOPs (multiply-adds x 2) -----------------------------------
    def tower_flops(self) -> float:
        """One image through the ViT and the Resampler."""
        d = self.d
        W, N, Fv, E, Q = d["W"], d["N"], d["Fv"], d["E"], d["Q"]
        per_layer = 2 * N * (4 * W * W + 2 * W * Fv) + 4 * N * N * W
        resampler = 2 * (N * W * E + Q * E * E + 2 * N * E * E + Q * E * E) + 4 * Q * N * E
        return 2 * N * 3 * d["P"] ** 2 * W + d["vL"] * per_layer + resampler + 2 * Q * E * E

    def position_flops(self, context: int) -> float:
        """One decoder position attending `context` positions (itself
        included), without the head."""
        d = self.d
        QD = d["H"] * d["Dh"]
        return d["L"] * (2 * (3 * QD * d["D"] + QD * d["D"] + 3 * d["F2"] * d["D"]) + 4 * QD * context)

    def head_flops(self) -> float:
        return 2 * self.d["V"] * self.d["D"]


