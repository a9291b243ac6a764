"""The plain references against the port's forwards, at tiny sizes on the
CPU, on the weights the benchmark makes: the towers' features and the
decoders' logits agree to fp32 rounding, and the references' own int8
rounding is the port's."""

import numpy as np
import pytest
import torch

from benchmark.reference import llava_mpt as mpt_ref
from benchmark.reference import qwen_vl as qwen_ref
from benchmark.reference.common import IMAGE_SENTINEL, pixels, weight_in
from benchmark.tests.helpers import tiny_config


def _image(size, seed):
    return np.random.default_rng(seed).integers(0, 256, (3, size, size), dtype=np.uint8)


def _splice(embed_row, ids, feats):
    return torch.cat([feats if t == IMAGE_SENTINEL else embed_row(t) for t in ids])[None]


@pytest.mark.parametrize("precision", ["float", "int8"])
def test_qwen_vl_reference_matches_port(precision):
    from llava_align_tpu_torch.models import qwen, qwen_vl
    from llava_align_tpu_torch.ops.image import normalize_device
    from llava_align_tpu_torch.ops.quant import quantize_qwen_params

    from benchmark.families.qwen_vl import Family

    cfg = tiny_config("qwen_vl_tiny.json")
    fam = Family(cfg)
    pcfg = fam.port_config()
    params = qwen_ref.make_weights(cfg, 5, "cpu")
    if precision == "int8":
        params = dict(params, qwen=quantize_qwen_params(params["qwen"]))
    u8 = _image(fam.image_size, 1)
    ids = [3, 4] + fam.image_block() + [9, 10, 11, 12, 13]
    with torch.inference_mode():
        feats = qwen_vl.encode_images(params, pcfg, normalize_device(torch.from_numpy(u8)[None], torch.float32))
        x = _splice(lambda t: qwen.embed_tokens(params["qwen"], torch.tensor([t])), ids, feats[0])
        hidden, _ = qwen.forward(params["qwen"], pcfg.text, x, torch.arange(x.shape[1])[None])
        port = qwen.logits_from_hidden(params["qwen"], hidden[0])
        ref = qwen_ref.Reference(cfg, 5, "cpu", precision=precision)
        rfeats = ref.encode(pixels(torch.from_numpy(u8)[None]))
        positions = list(range(x.shape[1]))
        (rlog,) = ref.logits([(ids, 0, positions)], rfeats)
    torch.testing.assert_close(rfeats, feats.float(), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(rlog, port, atol=1e-3, rtol=1e-4)


def test_llava_mpt_reference_matches_port():
    from llava_align_tpu_torch.models import clip_vit, mpt, projector
    from llava_align_tpu_torch.ops.image import normalize_device

    from benchmark.families.llava_mpt import Family

    cfg = tiny_config("llava_mpt_tiny.json")
    fam = Family(cfg)
    pcfg = fam.port_config()
    params = mpt_ref.make_weights(cfg, 6, "cpu")
    u8 = _image(fam.image_size, 2)
    ids = [5, 6, 7] + fam.image_block() + [8, 9, 10, 11]
    with torch.inference_mode():
        px = normalize_device(torch.from_numpy(u8)[None], torch.float32)
        feats = projector.forward(params["projector"], clip_vit.forward_features(params["vision"], pcfg.vision, px))
        x = _splice(lambda t: mpt.embed_tokens(params["mpt"], torch.tensor([t])), ids, feats[0])
        hidden, _ = mpt.forward(params["mpt"], pcfg.text, x, torch.arange(x.shape[1])[None])
        port = mpt.logits_from_hidden(params["mpt"], hidden[0])
        ref = mpt_ref.Reference(cfg, 6, "cpu")
        rfeats = ref.encode(pixels(torch.from_numpy(u8)[None]))
        (rlog,) = ref.logits([(ids, 0, list(range(x.shape[1])))], rfeats)
    torch.testing.assert_close(rfeats, feats.float(), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(rlog, port, atol=1e-3, rtol=1e-4)


def test_int8_rounding_is_the_ports():
    from llava_align_tpu_torch.ops.quant import dequantize, quantize_weight

    w = torch.randn(3, 96, 256, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    assert torch.equal(weight_in(w, "int8"), dequantize(quantize_weight(w), torch.float32))


@pytest.mark.parametrize("precision, worst", [("int8", 1 / 254), ("int4", 1 / 14), ("fp8", 1 / 16)])
def test_lower_precisions_round_within_their_step(precision, worst):
    w = torch.randn(4, 64, 256, generator=torch.Generator().manual_seed(1))
    err = (weight_in(w, precision) - w).abs()
    scale = w.abs().amax(dim=-1, keepdim=True)
    assert float((err / scale).max()) <= worst + 1e-6
    assert float(err.max()) > 0


def test_weights_are_made_from_the_seed():
    cfg = tiny_config("qwen_vl_tiny.json")
    a, b, c = (qwen_ref.make_weights(cfg, s, "cpu") for s in (3, 3, 4))
    assert torch.equal(a["qwen"]["layers"]["w1"], b["qwen"]["layers"]["w1"])
    assert not torch.equal(a["qwen"]["layers"]["w1"], c["qwen"]["layers"]["w1"])
