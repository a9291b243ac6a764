"""The port's bias probe (runners/bias_probe.py: the Figs 1/10 first-token
probes under meaningless inputs) against the JAX runner on random:tiny (the
JAX tiny fp32 tree and its port conversion): every record carries the same
keys (none, unk, zero, one, noise, and naive when an image is given) and
its top-k dicts the same tokens with probabilities within 1e-5 (fp32
softmaxes of logits that differ by ~1e-7). The noise-999 image is the one
draw the two frameworks make differently, so both runners' noise is made
from one numpy eps.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.config import LlavaConfig as JCfg
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.ops import noise as jnoise
from llava_align_tpu.runners import bias_probe as jbias
from llava_align_tpu.runners import common as jcommon
from llava_align_tpu_torch.config import LlavaConfig as TCfg
from llava_align_tpu_torch.evals.pope import load_jsonl
from llava_align_tpu_torch.ops import noise as tnoise
from llava_align_tpu_torch.runners import bias_probe as tbias
from llava_align_tpu_torch.runners import common as tcommon
from llava_align_tpu_torch.utils.jax_params import from_jax_params

TOL = 1e-5
DUMPS = ("none", "unk", "zero", "one", "noise")


@pytest.fixture(scope="module")
def models():
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCfg.tiny(vocab_size=512)))
    jm = jcommon.LoadedModel(jcommon.MockTokenizer(), jp, JCfg.tiny(vocab_size=512), "random-tiny")
    tm = tcommon.LoadedModel(tcommon.MockTokenizer(), from_jax_params(jp, device="cpu"),
                             TCfg.tiny(vocab_size=512), "random-tiny")
    return jm, tm


@pytest.fixture(scope="module")
def question_file(tmp_path_factory):
    """Three questions with an image (absent: --synthetic-images) and one
    without, so one record has no naive dump."""
    qf = tmp_path_factory.mktemp("bias_probe") / "probes.jsonl"
    lines = [{"question_id": i, "image": f"img_{i}.jpg", "text": f"Is there a {o} in the image?"}
             for i, o in enumerate(("dog", "car", "cat"))]
    lines.append({"question_id": 3, "text": "Is the answer yes or no?"})
    qf.write_text("".join(json.dumps(l) + "\n" for l in lines))
    return str(qf)


@pytest.fixture
def patched(models, monkeypatch):
    jm, tm = models
    monkeypatch.setattr(jbias, "load_model", lambda *a, **k: jm)
    monkeypatch.setattr(tbias, "load_model", lambda *a, **k: tm)
    H = jm.cfg.vision.image_size
    eps = np.random.default_rng(3).standard_normal((3, H, H)).astype(np.float32)

    def jax_noise(images, rng, noise_step):
        sqrt_ab, sqrt_1m_ab = (jnp.asarray(a) for a in jnoise.diffusion_schedule())
        return (sqrt_ab[noise_step] * images + sqrt_1m_ab[noise_step] * jnp.asarray(eps)).astype(images.dtype)

    def port_noise(image, noise_step, generator=None):
        return tnoise.add_diffusion_noise(image, noise_step, eps=torch.from_numpy(eps))

    monkeypatch.setattr(jbias, "add_diffusion_noise", jax_noise)
    monkeypatch.setattr(tbias, "add_diffusion_noise", port_noise)


def _args(mod, qf, answers, **kw):
    args = mod.build_parser().parse_args(
        ["--model-path", "random:tiny", "--question-file", qf, "--answers-file", answers])
    args.synthetic_images = True
    args.temperature = 0.0
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("kw", [{}, {"probe_top_k": 4, "one_word": True}], ids=["default", "top4_one_word"])
def test_bias_probe_records_equal_jax(patched, question_file, tmp_path, kw):
    paths = {}
    for name, mod, extra in (("jax", jbias, {}), ("port", tbias, {"device": "cpu"})):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        assert mod.run(_args(mod, question_file, paths[name], **extra, **kw)) == paths[name]
    got, want = load_jsonl(paths["port"]), load_jsonl(paths["jax"])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert set(DUMPS) <= set(g) and ("naive" in g) == (w["question_id"] < 3)
        assert g["question_id"] == w["question_id"] and g["prompt"] == w["prompt"]
        for key in set(g) - {"question_id", "prompt"}:
            assert g[key].keys() == w[key].keys(), (w["question_id"], key)
            for tok in w[key]:
                assert abs(g[key][tok] - w[key][tok]) <= TOL, (w["question_id"], key, tok)


def test_bias_probe_resumes(patched, question_file, tmp_path):
    """Two questions, then --resume: four records, each once."""
    out = str(tmp_path / "port.jsonl")
    tbias.run(_args(tbias, question_file, out, device="cpu", max_questions=2))
    tbias.run(_args(tbias, question_file, out, device="cpu", resume=True))
    assert [r["question_id"] for r in load_jsonl(out)] == [0, 1, 2, 3]
