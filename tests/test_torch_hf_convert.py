"""The port's HF-checkpoint loader (llava_align_tpu_torch/utils/hf_convert.py)
against the JAX package's, on tiny LLaVA checkpoints this test writes from
a numpy seed: `.safetensors` files (written with the safetensors package,
which only the test imports) and sharded `pytorch_model-*.bin` files, one
of them without an lm_head (tied to the embeddings).

- load_state_dict: the same tensors, bit for bit, as the JAX one (which
  reads .bin through fp32 and safetensors through numpy: F32 and F16 only);
- load_llava_checkpoint (and convert_*): leaf for leaf exact against
  from_jax_params of the JAX loader's tree, in fp32 and in bf16;
- config_from_hf on the published llava-v1.5-7b config keys: field by field;
- a greedy decode on the loaded tiny checkpoint: token-exact against the
  JAX engine on the JAX loader's tree;
- the port's safetensors reader against safetensors.safe_open on F32, F16,
  BF16 and integer tensors, aligned and not;
- load_model(<checkpoint dir>) with a tokenizer written beside it.

config_from_hf fixes the vision tower at ViT-L/336, so both modules'
ClipVisionConfig is swapped for the tiny one here.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.config import ClipVisionConfig as JClip
from llava_align_tpu.config import GenerationConfig as JGen
from llava_align_tpu.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
from llava_align_tpu.runners import common as jcommon
from llava_align_tpu.utils import hf_convert as jhf
from llava_align_tpu_torch.config import ClipVisionConfig as TClip
from llava_align_tpu_torch.config import GenerationConfig as TGen
from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine
from llava_align_tpu_torch.runners import common as tcommon
from llava_align_tpu_torch.utils import hf_convert as thf
from llava_align_tpu_torch.utils.jax_params import from_jax_params

VISION = "model.vision_tower.vision_tower.vision_model."
TINY_HF = {  # LlavaConfig.tiny's text widths under the llava-v1.5 config keys
    "architectures": ["LlavaLlamaForCausalLM"], "model_type": "llava", "vocab_size": 97,
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "max_position_embeddings": 512, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "mm_projector_type": "mlp2x_gelu", "mm_vision_select_layer": -2,
    "mm_vision_select_feature": "patch", "image_aspect_ratio": "pad", "mm_use_im_start_end": False,
    "mm_use_im_patch_token": False, "torch_dtype": "float16",
}
# the published liuhaotian/llava-v1.5-7b config.json's keys that config_from_hf reads
LLAVA_V15_7B_HF = {
    "architectures": ["LlavaLlamaForCausalLM"], "bos_token_id": 1, "eos_token_id": 2,
    "freeze_mm_mlp_adapter": False, "hidden_act": "silu", "hidden_size": 4096,
    "image_aspect_ratio": "pad", "initializer_range": 0.02, "intermediate_size": 11008,
    "max_length": 4096, "max_position_embeddings": 4096, "mm_hidden_size": 1024,
    "mm_projector_type": "mlp2x_gelu", "mm_use_im_patch_token": False, "mm_use_im_start_end": False,
    "mm_vision_select_feature": "patch", "mm_vision_select_layer": -2,
    "mm_vision_tower": "openai/clip-vit-large-patch14-336", "model_type": "llava",
    "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 32, "pad_token_id": 0,
    "pretraining_tp": 1, "rms_norm_eps": 1e-05, "rope_scaling": None, "tie_word_embeddings": False,
    "torch_dtype": "float16", "transformers_version": "4.31.0", "tune_mm_mlp_adapter": False,
    "use_cache": True, "use_mm_proj": True, "vocab_size": 32000,
}


@pytest.fixture(autouse=True)
def tiny_vision(monkeypatch):
    monkeypatch.setattr(jhf, "ClipVisionConfig", lambda **kw: dataclasses.replace(JClip.tiny(), **kw))
    monkeypatch.setattr(thf, "ClipVisionConfig", lambda **kw: dataclasses.replace(TClip.tiny(), **kw))


def hf_state_dict(seed: int, dtype: torch.dtype, lm_head: bool = True) -> dict:
    """A tiny llava-v1.5 state dict under the HF key names, from a numpy seed."""
    rng = np.random.default_rng(seed)
    vc = TClip.tiny()
    D, F, L, V, Dh, K = 64, 128, 2, 97, 16, 2
    vD, vF, vL, P = vc.hidden_size, vc.intermediate_size, vc.num_layers, vc.patch_size

    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.3).to(dtype)

    sd = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D)}
    if lm_head:
        sd["lm_head.weight"] = w(V, D)
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + w(D), p + "post_attention_layernorm.weight": 1 + w(D),
                   p + "self_attn.q_proj.weight": w(D, D), p + "self_attn.k_proj.weight": w(K * Dh, D),
                   p + "self_attn.v_proj.weight": w(K * Dh, D), p + "self_attn.o_proj.weight": w(D, D),
                   p + "mlp.gate_proj.weight": w(F, D), p + "mlp.up_proj.weight": w(F, D),
                   p + "mlp.down_proj.weight": w(D, F)})
    sd.update({VISION + "embeddings.class_embedding": w(vD),
               VISION + "embeddings.patch_embedding.weight": w(vD, 3, P, P),
               VISION + "embeddings.position_embedding.weight": w(1 + vc.num_patches, vD),
               VISION + "pre_layrnorm.weight": 1 + w(vD), VISION + "pre_layrnorm.bias": w(vD),
               VISION + "post_layernorm.weight": 1 + w(vD), VISION + "post_layernorm.bias": w(vD)})
    for i in range(vL):
        p = VISION + f"encoder.layers.{i}."
        for name in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = w(vD, vD), w(vD)
        for name in ("layer_norm1", "layer_norm2"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = 1 + w(vD), w(vD)
        sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"] = w(vF, vD), w(vF)
        sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"] = w(vD, vF), w(vD)
    sd.update({"model.mm_projector.0.weight": w(D, vD), "model.mm_projector.0.bias": w(D),
               "model.mm_projector.2.weight": w(D, D), "model.mm_projector.2.bias": w(D)})
    return sd


def write_checkpoint(root, fmt: str, seed: int = 0):
    """fmt: 'st_f32' / 'st_f16' (two .safetensors shards), 'bin_bf16' (two
    .bin shards), 'bin_f32_tied' (one .bin, no lm_head)."""
    from safetensors.torch import save_file

    dtype = {"st_f32": torch.float32, "st_f16": torch.float16, "bin_bf16": torch.bfloat16,
             "bin_f32_tied": torch.float32}[fmt]
    sd = hf_state_dict(seed, dtype, lm_head=fmt != "bin_f32_tied")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(TINY_HF, f)
    keys = sorted(sd)
    shards = [keys[: len(keys) // 2], keys[len(keys) // 2:]] if fmt != "bin_f32_tied" else [keys]
    for n, part in enumerate(shards, 1):
        chunk = {k: sd[k] for k in part}
        if fmt.startswith("st"):
            save_file(chunk, os.path.join(root, f"model-{n:05d}-of-{len(shards):05d}.safetensors"))
        else:
            torch.save(chunk, os.path.join(root, f"pytorch_model-{n:05d}-of-{len(shards):05d}.bin"))
    return sd


FORMATS = ["st_f32", "st_f16", "bin_bf16", "bin_f32_tied"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_load_state_dict_bit_equal_to_jax(tmp_path, fmt):
    src = write_checkpoint(str(tmp_path), fmt)
    got, want = thf.load_state_dict(str(tmp_path)), jhf.load_state_dict(str(tmp_path))
    assert sorted(got) == sorted(want) == sorted(src)
    for k in src:
        assert got[k].dtype == src[k].dtype and got[k].device.type == "cpu", k
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32), err_msg=k)
        assert torch.equal(got[k], src[k]), k


def _assert_trees_equal(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert torch.equal(got, want), path


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_load_llava_checkpoint_leaf_exact_vs_jax(tmp_path, fmt, dtype):
    write_checkpoint(str(tmp_path), fmt)
    tdt, jdt = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    got, cfg = thf.load_llava_checkpoint(str(tmp_path), tdt, device="cpu")
    jparams, jcfg = jhf.load_llava_checkpoint(str(tmp_path), jdt)
    _assert_trees_equal(got, from_jax_params(jax.device_get(jparams), device="cpu"))
    assert cfg.text.dtype == tdt and cfg.vision.num_layers == jcfg.vision.num_layers
    if fmt == "bin_f32_tied":
        assert torch.equal(got["llama"]["lm_head"], got["llama"]["embed"])


@pytest.mark.parametrize("which", ["llama", "clip", "projector"])
def test_convert_functions_leaf_exact_vs_jax(which):
    """convert_* on one in-memory state dict (the JAX ones take numpy)."""
    sd = hf_state_dict(3, torch.float32)
    sd_np = {k: v.numpy() for k, v in sd.items()}
    cfg = thf.config_from_hf(TINY_HF, torch.float32)
    jcfg = jhf.config_from_hf(TINY_HF, jnp.float32)
    if which == "llama":
        got, want = thf.convert_llama(sd, cfg.text, device="cpu"), jhf.convert_llama(sd_np, jcfg.text)
    elif which == "clip":
        got = thf.convert_clip(sd, cfg.vision, prefix=VISION, device="cpu")
        want = jhf.convert_clip(sd_np, jcfg.vision, prefix=VISION)
    else:
        got = thf.convert_projector(sd, "mlp2x_gelu", torch.float32, device="cpu")
        want = jhf.convert_projector(sd_np, "mlp2x_gelu", jnp.float32)
    _assert_trees_equal(got, from_jax_params(jax.device_get(want), device="cpu"))


def test_config_from_hf_matches_jax_on_llava_v15_7b(monkeypatch):
    monkeypatch.setattr(jhf, "ClipVisionConfig", JClip)
    monkeypatch.setattr(thf, "ClipVisionConfig", TClip)
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        got, want = thf.config_from_hf(LLAVA_V15_7B_HF, tdt), jhf.config_from_hf(LLAVA_V15_7B_HF, jdt)

        def fields(cfg):
            out = {}
            for f in dataclasses.fields(cfg):
                v = getattr(cfg, f.name)
                if dataclasses.is_dataclass(v):
                    v = fields(v)
                elif f.name == "dtype":
                    v = np.dtype(v).name if not isinstance(v, torch.dtype) else str(v)[6:]
                out[f.name] = v
            return out

        assert fields(got) == fields(want)
        assert got.text.num_layers == 32 and got.vision.hidden_size == 1024 and got.num_image_tokens == 576


@pytest.mark.parametrize("fmt", ["st_f32", "bin_bf16"])
def test_greedy_decode_on_loaded_checkpoint_vs_jax(tmp_path, fmt):
    write_checkpoint(str(tmp_path), fmt)
    jparams, jcfg = jhf.load_llava_checkpoint(str(tmp_path), jnp.float32)
    tparams, tcfg = thf.load_llava_checkpoint(str(tmp_path), torch.float32, device="cpu")
    flags = dict(max_new_tokens=6, do_sample=False, eos_token_id=2, use_dd=True, use_dd_unk=True,
                 cd_alpha=1.0, cd_beta=0.1)
    ids = [1, 40, 50, IMAGE_TOKEN_INDEX, 60, 70, 80]
    image = np.random.default_rng(1).integers(0, 256, (3, 28, 28), dtype=np.uint8)
    want = JEngine(jparams, jcfg, JGen(**flags), attn_impl="xla", bucket=16).generate(ids, image)
    got = TEngine(tparams, tcfg, TGen(**flags), bucket=16).generate(ids, image)
    assert got.token_ids == want.token_ids and got.prompt_length == want.prompt_length
    np.testing.assert_allclose(got.first_scores_top_probs, want.first_scores_top_probs, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.int64])
def test_safetensors_reader_matches_safe_open(tmp_path, dtype):
    """Odd element counts put later tensors off their element alignment
    (those the reader copies out of the map)."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    rng = np.random.default_rng(2)
    tensors = {}
    for i, shape in enumerate([(3,), (5, 7), (1,), (2, 3, 4), (0,), (9,)]):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 50)
        tensors[f"t{i}"] = x.to(dtype)
        tensors[f"u{i}"] = torch.from_numpy(rng.integers(0, 255, shape).astype(np.uint8))
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = thf.read_safetensors(path)
    with safe_open(path, framework="pt") as h:
        assert sorted(got) == sorted(h.keys())
        for k in h.keys():
            want = h.get_tensor(k)
            assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
            assert torch.equal(got[k], want), k


def _write_tokenizer(root):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["<unk>", "<s>", "</s>"] + [chr(c) for c in range(33, 127)]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(root)


def test_load_model_loads_a_checkpoint_dir(tmp_path):
    """load_model(<dir>) no longer refuses a checkpoint: the same tree as
    load_llava_checkpoint (bf16), the tokenizer from the dir, the JAX
    package's model name; quant='int8' quantizes the decoder."""
    root = str(tmp_path / "llava-v1.5-7b-tiny")
    write_checkpoint(root, "bin_bf16")
    _write_tokenizer(root)
    lm = tcommon.load_model(root, device="cpu")
    jlm = jcommon.load_model(root)
    assert lm.model_name == jlm.model_name == "llava-v1.5-7b-tiny"
    _assert_trees_equal(lm.params, from_jax_params(jax.device_get(jlm.params), device="cpu"))
    assert lm.tokenizer("a b").input_ids == jlm.tokenizer("a b").input_ids
    q = tcommon.load_model(root, quant="int8", device="cpu")
    assert q.params["llama"]["layers"]["qkv"]["q"].dtype == torch.int8
    with pytest.raises(FileNotFoundError):
        tcommon.load_model(str(tmp_path / "missing"), device="cpu")
