"""The port's Qwen-VL checkpoint loader (utils/hf_convert.convert_qwen,
convert_qwen_visual, load_qwen_vl_checkpoint) against the JAX package's, on
tiny Qwen-VL checkpoints this test writes from a numpy seed under the HF
key names: `.safetensors` files in F32 (written with the safetensors
package, which only the test imports) and `pytorch_model-*.bin` shards in
bf16. The ViT's position table (3x3) and the Resampler's (2x2) come from
other grids than the 4x4 patch grid, so both loaders interpolate them.

- every leaf equals from_jax_params of the JAX loader's tree exactly, in
  fp32 and in bf16, and the configs agree field by field;
- a greedy dual-VDD decode of the loaded checkpoint is token-exact against
  the JAX engine on the JAX loader's tree.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.config import GenerationConfig as JGen
from llava_align_tpu.decoding.adapters import QwenVLAdapter as JAdapter
from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
from llava_align_tpu.models import qwen_vl as jqvl
from llava_align_tpu.utils import hf_convert as jhf
from llava_align_tpu_torch.config import GenerationConfig as TGen
from llava_align_tpu_torch.decoding.adapters import QwenVLAdapter as TAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine
from llava_align_tpu_torch.utils import hf_convert as thf
from llava_align_tpu_torch.utils.jax_params import from_jax_params

TINY_HF = {  # QwenVLConfig.tiny's widths under the Qwen-VL config.json keys
    "architectures": ["QWenLMHeadModel"], "model_type": "qwen", "vocab_size": 512, "hidden_size": 64,
    "num_hidden_layers": 2, "num_attention_heads": 4, "kv_channels": 16, "intermediate_size": 256,
    "layer_norm_epsilon": 1e-6, "rotary_emb_base": 10000, "seq_length": 128, "use_dynamic_ntk": True,
    "use_logn_attn": True,
    "visual": {"image_size": 56, "patch_size": 14, "width": 32, "layers": 2, "heads": 2, "mlp_ratio": 2.0,
               "n_queries": 4, "output_dim": 64, "image_start_id": 507},
}
V = "transformer.visual."


def hf_state_dict(seed: int, dtype: torch.dtype) -> dict:
    rng = np.random.default_rng(seed)
    D, L, Vc, QD, F2 = 64, 2, 512, 64, 128
    W, vL, Fv, E, P, Q = 32, 2, 64, 64, 14, 4

    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.3).to(dtype)

    sd = {"transformer.wte.weight": w(Vc, D), "transformer.ln_f.weight": 1 + w(D), "lm_head.weight": w(Vc, D)}
    for i in range(L):
        p = f"transformer.h.{i}."
        sd.update({p + "ln_1.weight": 1 + w(D), p + "ln_2.weight": 1 + w(D),
                   p + "attn.c_attn.weight": w(3 * QD, D), p + "attn.c_attn.bias": w(3 * QD),
                   p + "attn.c_proj.weight": w(D, QD), p + "mlp.w1.weight": w(F2, D),
                   p + "mlp.w2.weight": w(F2, D), p + "mlp.c_proj.weight": w(D, F2)})
    sd.update({V + "conv1.weight": w(W, 3, P, P), V + "positional_embedding": w(9, W),
               V + "ln_pre.weight": 1 + w(W), V + "ln_pre.bias": w(W),
               V + "ln_post.weight": 1 + w(E), V + "ln_post.bias": w(E), V + "proj": w(E, E)})
    for i in range(vL):
        p = V + f"transformer.resblocks.{i}."
        for name, (o, fan) in {"attn.in_proj": (3 * W, W), "attn.out_proj": (W, W), "mlp.c_fc": (Fv, W),
                               "mlp.c_proj": (W, Fv)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = w(o, fan), w(o)
        for name in ("ln_1", "ln_2"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = 1 + w(W), w(W)
    a = V + "attn_pool."
    sd.update({a + "query": w(Q, E), a + "pos_embed": w(Q, E), a + "kv_proj.weight": w(E, W),
               a + "ln_q.weight": 1 + w(E), a + "ln_q.bias": w(E), a + "ln_kv.weight": 1 + w(E),
               a + "ln_kv.bias": w(E), a + "attn.in_proj_weight": w(3 * E, E), a + "attn.in_proj_bias": w(3 * E),
               a + "attn.out_proj.weight": w(E, E), a + "attn.out_proj.bias": w(E)})
    return sd


def write_checkpoint(root: str, fmt: str, seed: int = 0) -> dict:
    """fmt 'st_f32' (two .safetensors shards) or 'bin_bf16' (two .bin shards)."""
    sd = hf_state_dict(seed, torch.float32 if fmt == "st_f32" else torch.bfloat16)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(TINY_HF, f)
    keys = sorted(sd)
    for n, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:]), 1):
        chunk = {k: sd[k] for k in part}
        if fmt == "st_f32":
            from safetensors.torch import save_file

            save_file(chunk, os.path.join(root, f"model-{n:05d}-of-00002.safetensors"))
        else:
            torch.save(chunk, os.path.join(root, f"pytorch_model-{n:05d}-of-00002.bin"))
    return sd


def _assert_trees_equal(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert torch.equal(got, want), path


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("fmt", ["st_f32", "bin_bf16"])
def test_load_qwen_vl_checkpoint_leaf_exact_vs_jax(tmp_path, fmt, dtype):
    write_checkpoint(str(tmp_path), fmt)
    tdt, jdt = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    got, cfg = thf.load_qwen_vl_checkpoint(str(tmp_path), tdt, device="cpu")
    jparams, jcfg = jhf.load_qwen_vl_checkpoint(str(tmp_path), jdt)
    _assert_trees_equal(got, from_jax_params(jax.device_get(jparams), device="cpu"))
    for tc, jc in ((cfg.text, jcfg.text), (cfg.vision, jcfg.vision)):
        assert {k: v for k, v in dataclasses.asdict(tc).items() if k != "dtype"} == {
            k: v for k, v in dataclasses.asdict(jc).items() if k != "dtype"}
        assert tc.dtype == tdt
    assert cfg.image_start_id == jcfg.image_start_id == 507
    assert got["visual"]["pos_embed"].shape == (16, 32) and got["visual"]["resampler"]["pos_kv"].shape == (16, 64)


def test_loaded_checkpoint_decodes_as_jax(tmp_path):
    write_checkpoint(str(tmp_path), "st_f32", seed=1)
    tp, cfg = thf.load_qwen_vl_checkpoint(str(tmp_path), torch.float32, device="cpu")
    jp, jcfg = jhf.load_qwen_vl_checkpoint(str(tmp_path), jnp.float32)
    span, _ = jqvl.sentinelize_span(jqvl.make_image_span_ids(jcfg), jcfg)
    ids = span + [40, 41, 42, 43, 44]
    image = np.random.default_rng(2).normal(size=(3, 56, 56)).astype(np.float32)
    flags = dict(max_new_tokens=4, do_sample=False, eos_token_id=2, use_dd=True, use_dd_unk=True)
    bids = {"unk": [7, 40, 41, 42, 43, 44]}
    want = JEngine(jp, jcfg, JGen(**flags), adapter=JAdapter(jcfg), attn_impl="xla", bucket=64).generate(
        ids, image, branch_ids=bids)
    got = TEngine(tp, cfg, TGen(**flags), adapter=TAdapter(cfg), bucket=64).generate(ids, image, branch_ids=bids)
    assert got.token_ids == want.token_ids
    np.testing.assert_allclose(got.first_scores_top_probs, want.first_scores_top_probs, rtol=0, atol=1e-5)
