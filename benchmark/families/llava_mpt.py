"""The LLaVA-MPT family on the program's side: the port's config from the
configuration file, the weights handed to the program (the benchmark's
own, served in bf16), the prompt's image block, and the model FLOPs the
mfu metrics count."""

from __future__ import annotations

from benchmark.reference import llava_mpt as ref
from benchmark.reference.common import IMAGE_SENTINEL


class Family:
    name = "llava_mpt"
    reference = ref

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.d = ref.dims(cfg)
        self.image_size = self.d["S_img"]
        self.num_image_tokens = self.d["N"]
        self.text_ids = (0, min(cfg["text_vocab"], self.d["V"]))
        self.bucket = cfg["serving"]["bucket"]
        self.sound_precision = "float"

    def image_block(self):
        return [IMAGE_SENTINEL]

    def none_ids(self, ids):
        return [t for t in ids if t != IMAGE_SENTINEL]

    def port_config(self):
        from llava_align_tpu_torch.config import ClipVisionConfig
        from llava_align_tpu_torch.models.llava_mpt import LlavaMptConfig
        from llava_align_tpu_torch.models.mpt import MptConfig

        c, v, d = self.cfg, self.cfg["vision"], self.d
        a = c["attn_config"]
        text = MptConfig(
            vocab_size=d["V"], d_model=d["D"], n_layers=d["L"], n_heads=d["H"],
            expansion_ratio=c["expansion_ratio"], max_seq_len=c["max_seq_len"], multiquery=False,
            qk_ln=a["qk_ln"], clip_qkv=a["clip_qkv"], alibi_bias_max=float(a["alibi_bias_max"]),
            no_bias=c["no_bias"], layer_norm_eps=d["eps"], dtype=d["dtype"])
        vision = ClipVisionConfig(
            image_size=v["image_size"], patch_size=v["patch_size"], hidden_size=v["hidden_size"],
            intermediate_size=v["intermediate_size"], num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"], layer_norm_eps=v["layer_norm_eps"],
            select_layer=v["select_layer"], select_feature="patch", dtype=d["dtype"])
        return LlavaMptConfig(text=text, vision=vision, mm_projector_type=c["mm_projector_type"])

    def build(self, seed: int, device):
        from llava_align_tpu_torch.decoding.adapters import LlavaMptAdapter

        pcfg = self.port_config()
        return ref.make_weights(self.cfg, seed, device), pcfg, LlavaMptAdapter(pcfg)

    def tower_flops(self) -> float:
        """One image through the CLIP layers LLaVA runs and the projector."""
        d = self.d
        vD, vF, N = d["vD"], d["vF"], d["N"] + 1
        sl = d["select_layer"]
        layers = d["vL"] + 1 + sl if sl < 0 else sl
        per_layer = 2 * N * (4 * vD * vD + 2 * vD * vF) + 4 * N * N * vD
        return 2 * d["N"] * 3 * d["P"] ** 2 * vD + layers * per_layer + 2 * d["N"] * (vD * d["D"] + d["D"] * d["D"])

    def position_flops(self, context: int) -> float:
        d = self.d
        return d["L"] * (2 * (4 * d["D"] * d["D"] + 2 * d["D"] * d["F"]) + 4 * d["D"] * context)

    def head_flops(self) -> float:
        return 2 * self.d["V"] * self.d["D"]
