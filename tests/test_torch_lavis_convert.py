"""The LAVIS zoo's converters and loaders in the port (utils/hf_convert
convert_blip_vit, convert_med, convert_blip, _pick_bert_prefix,
_zero_fill_cross, convert_albef, convert_blip_nlvr, convert_blip_variant,
convert_clip_full, convert_clip_openai, blip_config_from_json,
t5_config_from_json, _load_component_sd, load_blip_t5_composite) against
the JAX package's, on tiny state dicts under LAVIS / HF / open_clip key
names written here from a numpy seed: every tree leaf for leaf, exactly
(the JAX tree carried over by utils/jax_params). The composite is read
from a dir of components (a .safetensors dir with config.json, a single
.safetensors file, a LAVIS .pth with its 'model' envelope).

Then the zoo's front door: load_model builds every BLIP, ALBEF, CLIP and
BLIP-variant arch the JAX zoo registers (and BLIP-2's, on the CPU; tiny
random trees), each checkpointed arch loads a checkpoint dir, ModelZoo
lists them, and load_model_and_preprocess gives each family's processors.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from llava_align_tpu.models import albef as ja
from llava_align_tpu.models import blip as jb
from llava_align_tpu.models import blip_variants as jv
from llava_align_tpu.models import clip as jc
from llava_align_tpu.utils import hf_convert as jhf
from llava_align_tpu_torch.models import albef as ta
from llava_align_tpu_torch.models import blip as tb
from llava_align_tpu_torch.models import blip_variants as tv
from llava_align_tpu_torch.models import clip as tc
from llava_align_tpu_torch.utils import hf_convert as thf
from llava_align_tpu_torch.utils.jax_params import from_jax_params


def _w(seed):
    rng = np.random.default_rng(seed)

    def w(*shape, one=False):
        x = rng.standard_normal(shape[0] if shape and isinstance(shape[0], tuple) else shape)
        return torch.from_numpy(np.asarray(x * 0.3 + (1.0 if one else 0.0), np.float32))

    return w


def vit_sd(w, vc, prefix="visual_encoder.", qkv_bias=True) -> dict:
    D, F, P, N = vc.hidden_size, vc.ffn_dim, vc.patch_size, vc.num_patches
    sd = {prefix + "cls_token": w(1, 1, D), prefix + "pos_embed": w(1, N + 1, D),
          prefix + "patch_embed.proj.weight": w(D, 3, P, P), prefix + "patch_embed.proj.bias": w(D),
          prefix + "norm.weight": w(D, one=True), prefix + "norm.bias": w(D)}
    for i in range(vc.num_layers):
        b = f"{prefix}blocks.{i}."
        sd.update({b + "norm1.weight": w(D, one=True), b + "norm1.bias": w(D), b + "attn.qkv.weight": w(3 * D, D),
                   b + "attn.proj.weight": w(D, D), b + "attn.proj.bias": w(D), b + "norm2.weight": w(D, one=True),
                   b + "norm2.bias": w(D), b + "mlp.fc1.weight": w(F, D), b + "mlp.fc1.bias": w(F),
                   b + "mlp.fc2.weight": w(D, F), b + "mlp.fc2.bias": w(D)})
        if qkv_bias:
            sd[b + "attn.qkv.bias"] = w(3 * D)
    return sd


def med_sd(w, mc, prefix, cross_from=0, head=None, type_emb=True, twin=False, merge_from=None) -> dict:
    """An HF-Bert MED state dict: crossattention.* on the layers from
    cross_from (twin: NLVR's self0/self1 + dense0/dense1, merge_layer from
    merge_from), the MLM head under `head`."""
    D, F, V = mc.hidden_size, mc.intermediate_size, mc.vocab_size
    sd = {prefix + "embeddings.word_embeddings.weight": w(V, D),
          prefix + "embeddings.position_embeddings.weight": w(mc.max_position_embeddings, D),
          prefix + "embeddings.LayerNorm.weight": w(D, one=True), prefix + "embeddings.LayerNorm.bias": w(D)}
    if type_emb:
        sd[prefix + "embeddings.token_type_embeddings.weight"] = w(2, D)

    def lin(key, o, i):
        sd[key + ".weight"], sd[key + ".bias"] = w(o, i), w(o)

    def ln(key):
        sd[key + ".weight"], sd[key + ".bias"] = w(D, one=True), w(D)

    for i in range(mc.num_layers):
        b = f"{prefix}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            lin(b + "attention.self." + n, D, D)
        lin(b + "attention.output.dense", D, D)
        ln(b + "attention.output.LayerNorm")
        lin(b + "intermediate.dense", F, D)
        lin(b + "output.dense", D, F)
        ln(b + "output.LayerNorm")
        if i >= cross_from:
            x = b + "crossattention."
            for tw in ("0", "1") if twin else ("",):
                for n in ("query", "key", "value"):
                    lin(f"{x}self{tw}.{n}", D, D)
                lin(f"{x}output.dense{tw}", D, D)
            ln(x + "output.LayerNorm")
            if twin and i >= merge_from:
                lin(x + "output.merge_layer", D, 2 * D)
    if head:
        lin(head + "predictions.transform.dense", D, D)
        ln(head + "predictions.transform.LayerNorm")
        sd[head + "predictions.decoder.weight"], sd[head + "predictions.bias"] = w(V, D), w(V)
    return sd


def heads_sd(w, names: dict) -> dict:
    sd = {}
    for name, (o, i) in names.items():
        sd[name + ".weight"], sd[name + ".bias"] = w(o, i), w(o)
    return sd


def assert_trees_equal(got, want, path="root"):
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert torch.equal(got, want), path


def same(got_tree, jax_tree):
    assert_trees_equal(got_tree, from_jax_params(jax.device_get(jax_tree), device="cpu"))


def blip_sds(seed: int) -> dict:
    """Caption (text_decoder + cls head, no projections) and ITM
    (text_encoder + projections + itm_head, a qkv without bias) dicts."""
    c = tb.BlipConfig.tiny()
    w = _w(seed)
    D, E, Dv = c.text.hidden_size, c.embed_dim, c.vision.hidden_size
    cap = {**vit_sd(w, c.vision), **med_sd(w, c.text, "text_decoder.bert.", head="text_decoder.cls.",
                                         type_emb=False)}
    itm = {**vit_sd(w, c.vision, qkv_bias=False), **med_sd(w, c.text, "text_encoder.", type_emb=False),
           **heads_sd(w, {"vision_proj": (E, Dv), "text_proj": (E, D), "itm_head": (2, D)})}
    return {"caption": cap, "itm": itm}


@pytest.mark.parametrize("kind", ["caption", "itm"])
def test_convert_blip_leaf_exact(kind):
    sd = blip_sds(0)[kind]
    same(thf.convert_blip(sd, tb.BlipConfig.tiny(), device="cpu"), jhf.convert_blip(sd, jb.BlipConfig.tiny()))


@pytest.mark.parametrize("variant", ["retrieval", "pretrain", "vqa", "classification", "nlvr", "feature"])
def test_convert_albef_leaf_exact(variant):
    nlvr = variant == "nlvr"
    jcfg = ja.AlbefConfig.tiny(num_classes=3, nlvr=nlvr)
    tcfg = ta.AlbefConfig.tiny(num_classes=3, nlvr=nlvr)
    w = _w(1)
    D, E = tcfg.text.hidden_size, tcfg.embed_dim
    head = "text_encoder.cls." if variant == "pretrain" else None
    prefix = "text_encoder." if variant == "classification" else "text_encoder.bert."
    sd = {**vit_sd(w, tcfg.vision), **med_sd(w, tcfg.text, prefix, cross_from=tcfg.text.fusion_layer, head=head,
                                            type_emb=False),
          **heads_sd(w, {"vision_proj": (E, tcfg.vision.hidden_size), "text_proj": (E, D), "itm_head": (2, D),
                         "cls_head.0": (D, D), "cls_head.2": (3, D)}),
          "temp": torch.tensor([0.05])}
    if variant == "vqa":
        sd.update(med_sd(w, tcfg.decoder, "text_decoder.bert.", cross_from=1, head="text_decoder.cls."))
    same(thf.convert_albef(sd, tcfg, variant=variant, device="cpu"), jhf.convert_albef(sd, jcfg, variant=variant))


@pytest.mark.parametrize("variant", ["retrieval", "pretrain", "vqa", "classification", "nlvr"])
def test_convert_blip_variant_leaf_exact(variant):
    tcfg, jcfg = tb.BlipConfig.tiny(), jb.BlipConfig.tiny()
    w = _w(2)
    D, E = tcfg.text.hidden_size, tcfg.embed_dim
    if variant == "nlvr":
        tn, jn = tv.NlvrConfig(base=tcfg, num_classes=3, merge_from=1), jv.NlvrConfig(base=jcfg, num_classes=3,
                                                                                        merge_from=1)
        sd = {**vit_sd(w, tcfg.vision), **med_sd(w, tcfg.text, "text_encoder.", twin=True, merge_from=1),
              **heads_sd(w, {"cls_head.0": (D, D), "cls_head.2": (3, D)})}
        same(thf.convert_blip_nlvr(sd, tn, device="cpu"), jhf.convert_blip_nlvr(sd, jn))
        return
    sd = {**vit_sd(w, tcfg.vision), **med_sd(w, tcfg.text, "text_encoder.", type_emb=False),
          **heads_sd(w, {"vision_proj": (E, tcfg.vision.hidden_size), "text_proj": (E, D), "itm_head": (2, D),
                         "cls_head.0": (D, D), "cls_head.2": (4, D)})}
    if variant in ("vqa", "pretrain"):
        sd.update(med_sd(w, tcfg.text, "text_decoder.bert.", head="text_decoder.cls.", type_emb=False))
    same(thf.convert_blip_variant(sd, tcfg, variant, num_classes=4, device="cpu"),
         jhf.convert_blip_variant(sd, jcfg, variant, num_classes=4))


def clip_sds(seed: int) -> dict:
    c = tc.ClipConfig.tiny()
    w = _w(seed)
    v, t, E = c.vision, c.text, c.embed_dim
    Dv, Fv, P, Dt = v.hidden_size, v.intermediate_size, v.patch_size, t.width
    hf = {"vision_model.embeddings.class_embedding": w(Dv), "vision_model.embeddings.patch_embedding.weight":
          w(Dv, 3, P, P), "vision_model.embeddings.position_embedding.weight": w(1 + v.num_patches, Dv),
          "vision_model.pre_layrnorm.weight": w(Dv, one=True), "vision_model.pre_layrnorm.bias": w(Dv),
          "vision_model.post_layernorm.weight": w(Dv, one=True), "vision_model.post_layernorm.bias": w(Dv),
          "text_model.embeddings.token_embedding.weight": w(t.vocab_size, Dt),
          "text_model.embeddings.position_embedding.weight": w(t.context_length, Dt),
          "text_model.final_layer_norm.weight": w(Dt, one=True), "text_model.final_layer_norm.bias": w(Dt),
          "visual_projection.weight": w(E, Dv), "text_projection.weight": w(E, Dt), "logit_scale": w(1)}
    for prefix, L, D, F in (("vision_model.", v.num_layers, Dv, Fv), ("text_model.", t.num_layers, Dt, 4 * Dt)):
        for i in range(L):
            b = f"{prefix}encoder.layers.{i}."
            hf.update(heads_sd(w, {b + "self_attn.q_proj": (D, D), b + "self_attn.k_proj": (D, D),
                                   b + "self_attn.v_proj": (D, D), b + "self_attn.out_proj": (D, D),
                                   b + "mlp.fc1": (F, D), b + "mlp.fc2": (D, F)}))
            for n in ("layer_norm1", "layer_norm2"):
                hf[b + n + ".weight"], hf[b + n + ".bias"] = w(D, one=True), w(D)
    oc = {"visual.class_embedding": w(Dv), "visual.conv1.weight": w(Dv, 3, P, P),
          "visual.positional_embedding": w(1 + v.num_patches, Dv), "visual.ln_pre.weight": w(Dv, one=True),
          "visual.ln_pre.bias": w(Dv), "visual.ln_post.weight": w(Dv, one=True), "visual.ln_post.bias": w(Dv),
          "visual.proj": w(Dv, E), "token_embedding.weight": w(t.vocab_size, Dt),
          "positional_embedding": w(t.context_length, Dt), "ln_final.weight": w(Dt, one=True),
          "ln_final.bias": w(Dt), "text_projection": w(Dt, E), "logit_scale": w(())}
    for prefix, L, D, F in (("visual.transformer.resblocks.", v.num_layers, Dv, Fv),
                            ("transformer.resblocks.", t.num_layers, Dt, 4 * Dt)):
        for i in range(L):
            b = f"{prefix}{i}."
            oc.update({b + "attn.in_proj_weight": w(3 * D, D), b + "attn.in_proj_bias": w(3 * D)})
            oc.update(heads_sd(w, {b + "attn.out_proj": (D, D), b + "mlp.c_fc": (F, D), b + "mlp.c_proj": (D, F)}))
            for n in ("ln_1", "ln_2"):
                oc[b + n + ".weight"], oc[b + n + ".bias"] = w(D, one=True), w(D)
    return {"hf": hf, "openai": oc}


@pytest.mark.parametrize("kind", ["hf", "openai"])
def test_convert_clip_leaf_exact(kind):
    sd = clip_sds(3)[kind]
    t_conv, j_conv = ((thf.convert_clip_full, jhf.convert_clip_full) if kind == "hf"
                      else (thf.convert_clip_openai, jhf.convert_clip_openai))
    same(t_conv(sd, tc.ClipConfig.tiny(), device="cpu"), j_conv(sd, jc.ClipConfig.tiny()))


def test_config_readers_and_zero_fill():
    t5_json = {"vocab_size": 64, "d_model": 32, "d_kv": 8, "num_heads": 4, "d_ff": 48, "num_layers": 2,
               "num_decoder_layers": 1, "feed_forward_proj": "gated-gelu", "tie_word_embeddings": False}
    for d in (t5_json, {"feed_forward_proj": "relu"}, {}):
        got, want = thf.t5_config_from_json(d), jhf.t5_config_from_json(d)
        assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got) if f.name != "dtype"} == \
            {f.name: getattr(want, f.name) for f in dataclasses.fields(want) if f.name != "dtype"}
    for d in ({}, {"vision": {"image_size": 32, "patch_size": 16, "hidden_size": 32, "num_layers": 2, "num_heads": 4},
                   "text": {"vocab_size": 64, "hidden_size": 32, "num_layers": 2, "num_heads": 4,
                            "intermediate_size": 64}, "embed_dim": 16}):
        got, want = thf.blip_config_from_json(d), jhf.blip_config_from_json(d)
        for part in ("vision", "text"):
            g, w_ = getattr(got, part), getattr(want, part)
            assert {f.name: getattr(g, f.name) for f in dataclasses.fields(g) if f.name != "dtype"} == \
                {f.name: getattr(w_, f.name) for f in dataclasses.fields(w_) if f.name != "dtype"}
        assert got.embed_dim == want.embed_dim
    mc = tb.MedConfig.tiny()
    sd = med_sd(_w(4), mc, "text_encoder.bert.", cross_from=1)
    prefix = "text_encoder.bert."
    assert thf._pick_bert_prefix(sd, "text_encoder") == jhf._pick_bert_prefix(sd, "text_encoder") == prefix
    assert thf._pick_bert_prefix(sd, "text_decoder") is None and jhf._pick_bert_prefix(sd, "text_decoder") is None
    got, want = thf._zero_fill_cross(sd, "text_encoder.bert.", mc), jhf._zero_fill_cross(sd, "text_encoder.bert.", mc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], torch.as_tensor(np.asarray(want[k]))), k


def t5_sd(w, c) -> dict:
    D, F, V, H, Dk = c.d_model, c.d_ff, c.vocab_size, c.num_heads, c.d_kv
    sd = {"shared.weight": w(V, D), "encoder.final_layer_norm.weight": w(D, one=True),
          "decoder.final_layer_norm.weight": w(D, one=True), "lm_head.weight": w(V, D),
          **{f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
             w(c.relative_attention_num_buckets, H) for side in ("encoder", "decoder")}}

    def attn(b):
        for n in ("q", "k", "v"):
            sd[f"{b}.{n}.weight"] = w(H * Dk, D)
        sd[f"{b}.o.weight"] = w(D, H * Dk)

    def ffn(b):
        sd.update({f"{b}.DenseReluDense.wi_0.weight": w(F, D), f"{b}.DenseReluDense.wi_1.weight": w(F, D),
                   f"{b}.DenseReluDense.wo.weight": w(D, F)})

    for i in range(c.num_layers):
        b = f"encoder.block.{i}.layer."
        sd[b + "0.layer_norm.weight"], sd[b + "1.layer_norm.weight"] = w(D, one=True), w(D, one=True)
        attn(b + "0.SelfAttention")
        ffn(b + "1")
    for i in range(c.num_decoder_layers):
        b = f"decoder.block.{i}.layer."
        for j in range(3):
            sd[f"{b}{j}.layer_norm.weight"] = w(D, one=True)
        attn(b + "0.SelfAttention")
        attn(b + "1.EncDecAttention")
        ffn(b + "2")
    return sd


def test_load_blip_t5_composite_leaf_exact(tmp_path):
    """itm/ and cap/ (dirs: model.safetensors + config.json) and the T5 at
    an explicit path (a dir: pytorch_model.bin + config.json); then
    _load_component_sd on one .safetensors file and on a .pth with a
    'model' envelope."""
    from safetensors.torch import save_file

    blip_json = {"vision": {"image_size": 32, "patch_size": 16, "hidden_size": 32, "num_layers": 2, "num_heads": 4},
                 "text": {"vocab_size": 64, "hidden_size": 32, "num_layers": 2, "num_heads": 4,
                          "intermediate_size": 64, "max_position_embeddings": 64}, "embed_dim": 16}
    t5_json = {"vocab_size": 64, "d_model": 32, "d_kv": 8, "num_heads": 4, "d_ff": 48, "num_layers": 2,
               "num_decoder_layers": 2, "feed_forward_proj": "gated-gelu", "tie_word_embeddings": False}
    sds = blip_sds(5)
    for name, sd in (("itm", sds["itm"]), ("cap", sds["caption"])):
        (tmp_path / name).mkdir()
        save_file({k: v.contiguous() for k, v in sd.items()}, str(tmp_path / name / "model.safetensors"))
        (tmp_path / name / "config.json").write_text(json.dumps(blip_json))
    qa = tmp_path / "elsewhere"
    qa.mkdir()
    torch.save(t5_sd(_w(6), thf.t5_config_from_json(t5_json)), qa / "pytorch_model.bin")
    (qa / "config.json").write_text(json.dumps(t5_json))
    paths = {"qa": str(qa)}
    got_p, got_c = thf.load_blip_t5_composite(str(tmp_path), paths=paths, device="cpu")
    want_p, want_c = jhf.load_blip_t5_composite(str(tmp_path), paths=paths)
    for name in ("itm", "cap", "qa"):
        same(got_p[name], want_p[name])
    assert got_c["qa"].d_ff == want_c["qa"].d_ff == 48
    single = tmp_path / "cap.safetensors"
    save_file({k: v.contiguous() for k, v in sds["caption"].items()}, str(single))
    pth = tmp_path / "model.pth"
    torch.save({"model": sds["itm"]}, pth)
    for path, want in ((single, sds["caption"]), (pth, sds["itm"])):
        sd, cfg = thf._load_component_sd(str(path))
        j_sd, j_cfg = jhf._load_component_sd(str(path))
        assert cfg == j_cfg == {} and sorted(sd) == sorted(want) == sorted(j_sd)
        assert all(torch.equal(sd[k], want[k]) and np.array_equal(np.asarray(j_sd[k]), want[k].numpy()) for k in sd)
    with pytest.raises(FileNotFoundError, match="missing component"):
        thf.load_blip_t5_composite(str(tmp_path / "none"), device="cpu")


# every arch the JAX zoo registers for BLIP, its variants, ALBEF, CLIP and
# BLIP-2's LAVIS factories
LAVIS_ARCHS = ["blip_caption", "blip_image_text_matching", "blip_feature_extractor", "blip_retrieval", "blip_vqa",
               "blip_classification", "blip_nlvr", "blip_pretrain", "albef_retrieval", "albef_pretrain", "albef_vqa",
               "albef_classification", "albef_nlvr", "albef_feature_extractor", "clip", "clip_feature_extractor",
               "blip2", "blip2_feature_extractor", "blip2_image_text_matching", "blip2_opt", "blip2_t5",
               "blip2_t5_instruct"]


def test_zoo_registers_every_lavis_arch_of_the_jax_zoo():
    from llava_align_tpu.framework import model_zoo as jzoo
    from llava_align_tpu_torch.framework import model_zoo as tzoo

    j_names = {n for n, _ in jzoo.ModelZoo()}
    t_names = {n for n, _ in tzoo.ModelZoo()}
    assert set(LAVIS_ARCHS) <= j_names and set(LAVIS_ARCHS) <= t_names
    assert "clip" in str(tzoo.model_zoo) and len(tzoo.ModelZoo()) == len(t_names)
    for name in LAVIS_ARCHS:
        assert tzoo._preprocess_family(name) == jzoo._preprocess_family(name), name


def _fields(cfg) -> dict:
    """A config's fields, nested, without the dtypes (torch's and JAX's)."""
    return {f.name: _fields(getattr(cfg, f.name)) if dataclasses.is_dataclass(getattr(cfg, f.name))
            else getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


def _jax_tiny_cfg(arch: str):
    """The config the JAX zoo builds a random `arch` at."""
    from llava_align_tpu.models import blip2 as jb2

    if arch.startswith("blip2"):
        return (jb2.Blip2OptConfig.tiny() if arch == "blip2_opt" else jb2.Blip2T5Config.tiny()
                if arch.startswith("blip2_t5") else jb2.Blip2QformerConfig.tiny())
    if arch.startswith("albef"):
        return ja.AlbefConfig.tiny(num_classes=2 if arch in ("albef_classification", "albef_nlvr") else 0,
                                   nlvr=arch == "albef_nlvr")
    if arch.startswith("clip"):
        return jc.ClipConfig.tiny()
    return jv.NlvrConfig.tiny() if arch == "blip_nlvr" else jb.BlipConfig.tiny()


@pytest.mark.parametrize("arch", LAVIS_ARCHS)
def test_load_model_builds_each_arch(arch):
    """Each arch's tiny random tree at the JAX zoo's config, on the CPU when
    asked (the GPU is the default: without a card that raises), with its
    family's processors."""
    from llava_align_tpu_torch.framework.model_zoo import load_model, load_model_and_preprocess
    from llava_align_tpu_torch.framework.optims import tree_leaves

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_model(arch)
    model, vis, txt = load_model_and_preprocess(arch, device="cpu")
    assert model.arch == arch and all(x.device.type == "cpu" for x in tree_leaves(model.params))
    assert _fields(model.cfg) == _fields(_jax_tiny_cfg(arch))
    assert set(vis) == {"train", "eval"} and set(txt) == {"train", "eval"}


def test_load_model_reads_checkpoints(tmp_path, monkeypatch):
    """A checkpoint dir (model.safetensors) through load_model for BLIP,
    CLIP (both layouts) and ALBEF: each zoo entry's full config is swapped
    for the tiny one the checkpoints here are written at."""
    from safetensors.torch import save_file

    from llava_align_tpu_torch.framework.model_zoo import load_model

    def write(name, sd):
        d = tmp_path / name
        d.mkdir()
        save_file({k: v.contiguous() for k, v in sd.items()}, str(d / "model.safetensors"))
        return str(d)

    cap, clips = blip_sds(7)["caption"], clip_sds(8)
    tcfg = ta.AlbefConfig.tiny(num_classes=2)
    w = _w(9)
    D = tcfg.text.hidden_size
    albef_sd = {**vit_sd(w, tcfg.vision), **med_sd(w, tcfg.text, "text_encoder.bert.", cross_from=2, type_emb=False),
                **heads_sd(w, {"cls_head.0": (D, D), "cls_head.2": (2, D)})}
    for mod, name in ((tb, "BlipConfig"), (tc, "ClipConfig"), (ta, "AlbefConfig")):
        full = getattr(mod, name)

        class Tiny(full):
            def __new__(cls, *a, full=full, **kw):  # the zoo's full config → the tiny one
                if a or set(kw) - {"num_classes"}:
                    return full(*a, **kw)
                return full.tiny(**kw)

        monkeypatch.setattr(mod, name, Tiny)
    m = load_model("blip_caption", write("cap", cap), device="cpu")
    assert torch.equal(m.params["text"]["head"]["decoder"], cap["text_decoder.cls.predictions.decoder.weight"])
    for kind in ("hf", "openai"):
        m = load_model("clip", write(kind, clips[kind]), device="cpu")
        assert float(m.params["logit_scale"]) == float(clips[kind]["logit_scale"].reshape(()))
    m = load_model("albef_classification", write("albef", albef_sd), num_classes=2, device="cpu")
    assert torch.equal(m.params["cls_head"]["fc2"]["w"], albef_sd["cls_head.2.weight"])
