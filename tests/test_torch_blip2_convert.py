"""The port's BLIP-2, T5, OPT and MPT converters (utils/hf_convert.
convert_blip2_stage1, convert_blip2_opt, convert_blip2_t5 — through
_blip2_common — and convert_t5, convert_opt, convert_mpt) against the JAX
package's, on tiny state dicts under LAVIS / HF key names that this test
writes from a numpy seed. Each goes through both packages' converter in
fp32 and in bf16 (from F32 and from BF16 source tensors), and the trees
must match leaf for leaf, exactly (the JAX tree carried over by
utils/jax_params; the stage-1 `temp` a 0-d fp32 leaf in both). MPT is
held with and without qk_ln, with its norm biases absent (no_bias
checkpoints: zeros) and present. One BLIP-2 OPT checkpoint is also written
as .safetensors and .bin shards and read through load_state_dict.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.models import blip2 as jb2
from llava_align_tpu.models import mpt as jmpt
from llava_align_tpu.utils import hf_convert as jhf
from llava_align_tpu_torch.models import blip2 as tb2
from llava_align_tpu_torch.models import mpt as tmpt
from llava_align_tpu_torch.utils import hf_convert as thf
from llava_align_tpu_torch.utils.jax_params import from_jax_params

QF = "Qformer.bert."


def _w(seed, dtype):
    rng = np.random.default_rng(seed)

    def w(*shape, one=False):
        x = rng.standard_normal(shape).astype(np.float32) * 0.3 + (1.0 if one else 0.0)
        return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)

    return w


def vision_qformer_sd(w, cfg, prune_text: bool, head: bool) -> dict:
    """visual_encoder.*, ln_vision, query_tokens and Qformer.* (LAVIS)."""
    vc, qc = cfg.vision, cfg.qformer
    W, F, P, N = vc.width, vc.mlp_width, vc.patch_size, vc.num_patches
    v = "visual_encoder."
    sd = {v + "patch_embed.proj.weight": w(W, 3, P, P), v + "patch_embed.proj.bias": w(W),
          v + "cls_token": w(1, 1, W), v + "pos_embed": w(1, 1 + N, W)}
    for i in range(vc.num_layers):
        b = f"{v}blocks.{i}."
        for k, shape in (("norm1", (W,)), ("norm2", (W,))):
            sd[b + k + ".weight"], sd[b + k + ".bias"] = w(*shape, one=True), w(*shape)
        sd.update({b + "attn.qkv.weight": w(3 * W, W), b + "attn.q_bias": w(W), b + "attn.v_bias": w(W),
                   b + "attn.proj.weight": w(W, W), b + "attn.proj.bias": w(W), b + "mlp.fc1.weight": w(F, W),
                   b + "mlp.fc1.bias": w(F), b + "mlp.fc2.weight": w(W, F), b + "mlp.fc2.bias": w(W)})
    sd.update({"ln_vision.weight": w(W, one=True), "ln_vision.bias": w(W),
               "query_tokens": w(1, cfg.num_query_tokens, qc.hidden_size)})
    D, Fq, E = qc.hidden_size, qc.intermediate_size, qc.encoder_width
    sd.update({QF + "embeddings.LayerNorm.weight": w(D, one=True), QF + "embeddings.LayerNorm.bias": w(D)})
    if not prune_text:
        sd[QF + "embeddings.word_embeddings.weight"] = w(qc.vocab_size, D)
        sd[QF + "embeddings.position_embeddings.weight"] = w(qc.max_position_embeddings, D)

    def dense(key, o, i):
        sd[key + ".weight"], sd[key + ".bias"] = w(o, i), w(o)

    def ln(key):
        sd[key + ".weight"], sd[key + ".bias"] = w(D, one=True), w(D)

    for i in range(qc.num_layers):
        b = f"{QF}encoder.layer.{i}."
        for att, kv in (("attention", D), ("crossattention", E)):
            if att == "crossattention" and i % qc.cross_attention_freq:
                continue
            for name, kin in (("self.query", D), ("self.key", kv), ("self.value", kv), ("output.dense", D)):
                dense(b + att + "." + name, D, kin)
            ln(b + att + ".output.LayerNorm")
        dense(b + "intermediate_query.dense", Fq, D)
        dense(b + "output_query.dense", D, Fq)
        ln(b + "output_query.LayerNorm")
        if not prune_text:
            dense(b + "intermediate.dense", Fq, D)
            dense(b + "output.dense", D, Fq)
            ln(b + "output.LayerNorm")
    if head:
        h = "Qformer.cls.predictions."
        dense(h + "transform.dense", D, D)
        sd[h + "transform.LayerNorm.weight"], sd[h + "transform.LayerNorm.bias"] = w(D, one=True), w(D)
        sd[h + "decoder.weight"], sd[h + "bias"] = w(qc.vocab_size, D), w(qc.vocab_size)
    return sd


def opt_sd(w, t, prefix: str) -> dict:
    p = prefix + "model.decoder."
    D, F = t.hidden_size, t.ffn_dim
    sd = {p + "embed_tokens.weight": w(t.vocab_size, D), p + "embed_positions.weight": w(t.max_position_embeddings + 2, D),
          p + "final_layer_norm.weight": w(D, one=True), p + "final_layer_norm.bias": w(D)}
    for i in range(t.num_layers):
        b = f"{p}layers.{i}."
        for name, o, k in (("self_attn.q_proj", D, D), ("self_attn.k_proj", D, D), ("self_attn.v_proj", D, D),
                           ("self_attn.out_proj", D, D), ("fc1", F, D), ("fc2", D, F)):
            sd[b + name + ".weight"], sd[b + name + ".bias"] = w(o, k), w(o)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            sd[b + name + ".weight"], sd[b + name + ".bias"] = w(D, one=True), w(D)
    return sd


def t5_sd(w, t, prefix: str) -> dict:
    p = prefix
    D, I, F = t.d_model, t.inner_dim, t.d_ff
    sd = {p + "shared.weight": w(t.vocab_size, D), p + "lm_head.weight": w(t.vocab_size, D),
          p + "encoder.final_layer_norm.weight": w(D, one=True), p + "decoder.final_layer_norm.weight": w(D, one=True)}

    def attn(base):
        for n, o, i in (("q", I, D), ("k", I, D), ("v", I, D), ("o", D, I)):
            sd[f"{base}.{n}.weight"] = w(o, i)

    def ffn(base):
        for n, o, i in (("wi_0", F, D), ("wi_1", F, D), ("wo", D, F)):
            sd[f"{base}.DenseReluDense.{n}.weight"] = w(o, i)

    for side, n_layers, blocks in (("encoder", t.num_layers, ("SelfAttention",)),
                                   ("decoder", t.num_decoder_layers, ("SelfAttention", "EncDecAttention"))):
        sd[f"{p}{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = w(
            t.relative_attention_num_buckets, t.num_heads)
        for i in range(n_layers):
            for j, blk in enumerate(blocks):
                attn(f"{p}{side}.block.{i}.layer.{j}.{blk}")
                sd[f"{p}{side}.block.{i}.layer.{j}.layer_norm.weight"] = w(D, one=True)
            j = len(blocks)
            ffn(f"{p}{side}.block.{i}.layer.{j}")
            sd[f"{p}{side}.block.{i}.layer.{j}.layer_norm.weight"] = w(D, one=True)
    return sd


def mpt_sd(w, t, qk_ln: bool, biases: bool) -> dict:
    p = "transformer."
    D, F, KV = t.d_model, t.ffn_dim, t.kv_heads * t.head_dim
    sd = {p + "wte.weight": w(t.vocab_size, D), p + "norm_f.weight": w(D, one=True)}
    if biases:
        sd[p + "norm_f.bias"] = w(D)
    for i in range(t.n_layers):
        b = f"{p}blocks.{i}."
        sd.update({b + "attn.Wqkv.weight": w(D + 2 * KV, D), b + "attn.out_proj.weight": w(D, D),
                   b + "ffn.up_proj.weight": w(F, D), b + "ffn.down_proj.weight": w(D, F)})
        norms = [("norm_1", D), ("norm_2", D)] + ([("attn.q_ln", D), ("attn.k_ln", KV)] if qk_ln else [])
        for name, width in norms:
            sd[b + name + ".weight"] = w(width, one=True)
            if biases:
                sd[b + name + ".bias"] = w(width)
    return sd


def assert_trees_equal(got, want, path="root"):
    if want is None:
        assert got is None, path
        return
    if isinstance(want, (dict, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        if isinstance(want, dict):
            assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in (sorted(want) if isinstance(want, dict) else range(len(want))):
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype, got.shape)
        assert torch.equal(got, want), path


def _bf16(cfg, parts, jax_side: bool):
    dt = jnp.bfloat16 if jax_side else torch.bfloat16
    return dataclasses.replace(cfg, **{p: dataclasses.replace(getattr(cfg, p), dtype=dt) for p in parts})


FAMILIES = {  # name -> (JAX cfg, port cfg, JAX converter, port converter, state dict writer, cfg parts)
    "stage1": (jb2.Blip2QformerConfig.tiny(), tb2.Blip2QformerConfig.tiny(), jhf.convert_blip2_stage1,
               thf.convert_blip2_stage1,
               lambda w, c: {**vision_qformer_sd(w, c, False, True), "vision_proj.weight": w(16, 48),
                             "vision_proj.bias": w(16), "text_proj.weight": w(16, 48), "text_proj.bias": w(16),
                             "itm_head.weight": w(2, 48), "itm_head.bias": w(2), "temp": w()},
               ("vision", "qformer")),
    "opt": (jb2.Blip2OptConfig.tiny(), tb2.Blip2OptConfig.tiny(), jhf.convert_blip2_opt, thf.convert_blip2_opt,
            lambda w, c: {**vision_qformer_sd(w, c, True, False), "opt_proj.weight": w(64, 48),
                          "opt_proj.bias": w(64), **opt_sd(w, c.text, "opt_model.")},
            ("vision", "qformer", "text")),
    "t5": (jb2.Blip2T5Config.tiny(), tb2.Blip2T5Config.tiny(), jhf.convert_blip2_t5, thf.convert_blip2_t5,
           lambda w, c: {**vision_qformer_sd(w, c, False, False), "t5_proj.weight": w(32, 48),
                         "t5_proj.bias": w(32), **t5_sd(w, c.text, "t5_model.")},
           ("vision", "qformer", "text")),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_blip2_converters_leaf_exact_vs_jax(family, dtype):
    jcfg, tcfg, jconv, tconv, build, parts = FAMILIES[family]
    if dtype == "bf16":
        jcfg, tcfg = _bf16(jcfg, parts, True), _bf16(tcfg, parts, False)
    sd = build(_w(0, torch.float32 if dtype == "fp32" else torch.bfloat16), tcfg)
    want = from_jax_params(jax.device_get(jconv(sd, jcfg)), device="cpu")
    got = tconv(sd, tcfg, device="cpu")
    assert_trees_equal(got, want)
    if family == "stage1":
        assert got["temp"].dtype == torch.float32 and got["temp"].dim() == 0
        assert "head" in got["qformer"]


@pytest.mark.parametrize("qk_ln,biases", [(False, False), (True, True), (True, False)])
@pytest.mark.parametrize("multiquery", [False, True], ids=["mha", "mqa"])
def test_convert_mpt_leaf_exact_vs_jax(qk_ln, biases, multiquery):
    jcfg = dataclasses.replace(jmpt.MptConfig.tiny(multiquery=multiquery), qk_ln=qk_ln)
    tcfg = dataclasses.replace(tmpt.MptConfig.tiny(multiquery=multiquery), qk_ln=qk_ln)
    sd = mpt_sd(_w(1, torch.bfloat16), tcfg, qk_ln, biases)
    want = from_jax_params(jax.device_get(jhf.convert_mpt(sd, jcfg)), device="cpu")
    got = thf.convert_mpt(sd, tcfg, device="cpu")
    assert_trees_equal(got, want)
    assert ("q_ln" in got["layers"]) == qk_ln


def test_blip2_opt_checkpoint_files_through_load_state_dict(tmp_path):
    """A two-shard .safetensors (F32) and a two-shard .bin (BF16) copy of
    one BLIP-2 OPT state dict: both packages' load_state_dict, then the
    converters, leaf-exact."""
    jcfg, tcfg, jconv, tconv, build, _ = FAMILIES["opt"]
    for fmt, dtype in (("st", torch.float32), ("bin", torch.bfloat16)):
        root = tmp_path / fmt
        root.mkdir()
        sd = build(_w(2, dtype), tcfg)
        keys = sorted(sd)
        for n, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:]), 1):
            chunk = {k: sd[k].contiguous() for k in part}
            if fmt == "st":
                from safetensors.torch import save_file

                save_file(chunk, os.path.join(root, f"model-{n:05d}-of-00002.safetensors"))
            else:
                torch.save(chunk, os.path.join(root, f"pytorch_model-{n:05d}-of-00002.bin"))
        want = from_jax_params(jax.device_get(jconv(jhf.load_state_dict(str(root)), jcfg)), device="cpu")
        assert_trees_equal(tconv(thf.load_state_dict(str(root)), tcfg, device="cpu"), want)
