"""The port's InstructBLIP converters (utils/hf_convert.convert_eva_vit,
convert_qformer, convert_instructblip) against the JAX package's, on a tiny
blip2_vicuna_instruct state dict under LAVIS key names that this test
writes from a numpy seed, as two .safetensors shards (F32, written with the
safetensors package, which only the test imports) and as two .bin shards
(BF16). Each goes through both packages' load_state_dict and
convert_instructblip, in fp32 and in bf16, and the trees must match leaf
for leaf, exactly (the JAX tree carried over by utils/jax_params).

convert_qformer is also held whole: a BLIP-2 OPT/T5-style state dict whose
text branch was pruned (no word/position embeddings, no text feed-forward)
and a BertLMHeadModel's MLM head under head_prefix.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.models.instructblip import InstructBlipConfig as JCfg
from llava_align_tpu.utils import hf_convert as jhf
from llava_align_tpu_torch.models.instructblip import InstructBlipConfig as TCfg
from llava_align_tpu_torch.utils import hf_convert as thf
from llava_align_tpu_torch.utils.jax_params import from_jax_params

QF = "Qformer.bert."


def _w(rng, dtype):
    def w(*shape, one=False):
        x = rng.standard_normal(shape).astype(np.float32) * 0.3 + (1.0 if one else 0.0)
        return torch.from_numpy(x).to(dtype)

    return w


def _qformer_sd(w, cfg, prune_text=False, head=False) -> dict:
    D, F, E, P = cfg.hidden_size, cfg.intermediate_size, cfg.encoder_width, cfg.max_position_embeddings
    sd = {QF + "embeddings.LayerNorm.weight": w(D, one=True), QF + "embeddings.LayerNorm.bias": w(D)}
    if not prune_text:
        sd[QF + "embeddings.word_embeddings.weight"] = w(cfg.vocab_size, D)
        sd[QF + "embeddings.position_embeddings.weight"] = w(P, D)

    def dense(key, o, i):
        sd[key + ".weight"], sd[key + ".bias"] = w(o, i), w(o)

    def ln(key):
        sd[key + ".weight"], sd[key + ".bias"] = w(D, one=True), w(D)

    for i in range(cfg.num_layers):
        b = f"{QF}encoder.layer.{i}."
        for att, kv in (("attention", D), ("crossattention", E)):
            if att == "crossattention" and i % cfg.cross_attention_freq:
                continue
            dense(b + att + ".self.query", D, D)
            dense(b + att + ".self.key", D, kv)
            dense(b + att + ".self.value", D, kv)
            dense(b + att + ".output.dense", D, D)
            ln(b + att + ".output.LayerNorm")
        dense(b + "intermediate_query.dense", F, D)
        dense(b + "output_query.dense", D, F)
        ln(b + "output_query.LayerNorm")
        if not prune_text:
            dense(b + "intermediate.dense", F, D)
            dense(b + "output.dense", D, F)
            ln(b + "output.LayerNorm")
    if head:
        h = "Qformer.cls.predictions."
        dense(h + "transform.dense", D, D)
        sd[h + "transform.LayerNorm.weight"], sd[h + "transform.LayerNorm.bias"] = w(D, one=True), w(D)
        sd[h + "decoder.weight"], sd[h + "bias"] = w(cfg.vocab_size, D), w(cfg.vocab_size)
    return sd


def lavis_state_dict(seed: int, dtype: torch.dtype) -> dict:
    """blip2_vicuna_instruct keys at InstructBlipConfig.tiny's widths."""
    cfg = TCfg.tiny()
    w = _w(np.random.default_rng(seed), dtype)
    vc, t = cfg.vision, cfg.text
    W, F, P, N = vc.width, vc.mlp_width, vc.patch_size, vc.num_patches
    v = "visual_encoder."
    sd = {v + "patch_embed.proj.weight": w(W, 3, P, P), v + "patch_embed.proj.bias": w(W),
          v + "cls_token": w(1, 1, W), v + "pos_embed": w(1, 1 + N, W)}
    for i in range(vc.num_layers):
        b = f"{v}blocks.{i}."
        sd.update({b + "norm1.weight": w(W, one=True), b + "norm1.bias": w(W), b + "attn.qkv.weight": w(3 * W, W),
                   b + "attn.q_bias": w(W), b + "attn.v_bias": w(W), b + "attn.proj.weight": w(W, W),
                   b + "attn.proj.bias": w(W), b + "norm2.weight": w(W, one=True), b + "norm2.bias": w(W),
                   b + "mlp.fc1.weight": w(F, W), b + "mlp.fc1.bias": w(F), b + "mlp.fc2.weight": w(W, F),
                   b + "mlp.fc2.bias": w(W)})
    sd.update({"ln_vision.weight": w(W, one=True), "ln_vision.bias": w(W),
               "query_tokens": w(1, cfg.num_query_tokens, cfg.qformer.hidden_size)})
    sd.update(_qformer_sd(w, cfg.qformer))
    sd.update({"llm_proj.weight": w(t.hidden_size, cfg.qformer.hidden_size), "llm_proj.bias": w(t.hidden_size)})
    lm = "llm_model."
    D, Fl, V = t.hidden_size, t.intermediate_size, t.vocab_size
    sd.update({lm + "model.embed_tokens.weight": w(V, D), lm + "model.norm.weight": w(D, one=True),
               lm + "lm_head.weight": w(V, D)})
    for i in range(t.num_layers):
        b = f"{lm}model.layers.{i}."
        sd.update({b + "input_layernorm.weight": w(D, one=True), b + "post_attention_layernorm.weight": w(D, one=True),
                   b + "self_attn.q_proj.weight": w(t.q_dim, D), b + "self_attn.k_proj.weight": w(t.kv_dim, D),
                   b + "self_attn.v_proj.weight": w(t.kv_dim, D), b + "self_attn.o_proj.weight": w(D, t.q_dim),
                   b + "mlp.gate_proj.weight": w(Fl, D), b + "mlp.up_proj.weight": w(Fl, D),
                   b + "mlp.down_proj.weight": w(D, Fl)})
    return sd


def write_checkpoint(root: str, fmt: str, seed: int = 0) -> dict:
    """fmt 'st_f32' (two .safetensors shards) or 'bin_bf16' (two .bin shards)."""
    sd = lavis_state_dict(seed, torch.float32 if fmt == "st_f32" else torch.bfloat16)
    keys = sorted(sd)
    for n, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:]), 1):
        chunk = {k: sd[k].contiguous() for k in part}
        if fmt == "st_f32":
            from safetensors.torch import save_file

            save_file(chunk, os.path.join(root, f"model-{n:05d}-of-00002.safetensors"))
        else:
            torch.save(chunk, os.path.join(root, f"pytorch_model-{n:05d}-of-00002.bin"))
    return sd


def _assert_trees_equal(got, want, path="root"):
    if isinstance(want, (dict, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        keys = sorted(want) if isinstance(want, dict) else range(len(want))
        if isinstance(want, dict):
            assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in keys:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype, got.shape)
        assert torch.equal(got, want), path


def _cfgs(dtype: str):
    if dtype == "fp32":
        return JCfg.tiny(), TCfg.tiny()
    out = []
    for cfg, bf16 in ((JCfg.tiny(), jnp.bfloat16), (TCfg.tiny(), torch.bfloat16)):
        out.append(dataclasses.replace(cfg, **{part: dataclasses.replace(getattr(cfg, part), dtype=bf16)
                                               for part in ("vision", "qformer", "text")}))
    return tuple(out)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("fmt", ["st_f32", "bin_bf16"])
def test_convert_instructblip_leaf_exact_vs_jax(tmp_path, fmt, dtype):
    write_checkpoint(str(tmp_path), fmt)
    jcfg, tcfg = _cfgs(dtype)
    want = jhf.convert_instructblip(jhf.load_state_dict(str(tmp_path)), jcfg)
    got = thf.convert_instructblip(thf.load_state_dict(str(tmp_path)), tcfg, device="cpu")
    _assert_trees_equal(got, from_jax_params(jax.device_get(want), device="cpu"))
    assert got["visual"]["patch_embed"]["w"].shape == (32, 3 * 14 * 14)
    assert [("cross_attn" in lp) for lp in got["qformer"]["layers"]] == [True, False, True]


def test_convert_qformer_pruned_text_and_head_vs_jax():
    jcfg, tcfg = JCfg.tiny().qformer, TCfg.tiny().qformer
    sd = _qformer_sd(_w(np.random.default_rng(3), torch.float32), tcfg, prune_text=True, head=True)
    want = jhf.convert_qformer(sd, jcfg, head_prefix="Qformer.cls.")
    got = thf.convert_qformer(sd, tcfg, head_prefix="Qformer.cls.", device="cpu")
    _assert_trees_equal(got, from_jax_params(jax.device_get(want), device="cpu"))
    assert not got["embeddings"]["word"].any() and bool((got["layers"][0]["output_ln"]["scale"] == 1).all())
