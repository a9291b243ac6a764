"""The port's InstructBLIP runners against the JAX package's, on the tiny
random InstructBLIP tree (the JAX one, and its port conversion; each
runner's load_blip_model patched to return it) with the mock tokenizer on
both sides and image files absent (--synthetic-images):

- runners/blip_pope.run, greedy, --calibrate, plain and --use_cd: every
  record equals the JAX runner's, texts and ids exactly, the naive / none /
  noise top-k dicts (and logits_score) within 1e-5. The diffusion noise is
  the one thing the two runners draw differently (jax.random against a
  torch.Generator), so both are given one eps per noise step, made with
  numpy;
- runners/caption.run at 2 and 5 beams: val_epoch0.json equals JAX's;
- --dist auto refused as the POPE runner refuses it; --quant w8a8 (once
  refused) read by nothing, as in the JAX runner; load_blip_model's random:* tree, and a checkpoint dir whose tokenizers
  need transformers when it is absent.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import one_torch_thread  # noqa: F401 (a fixture)
from llava_align_tpu.models import instructblip as jblip
from llava_align_tpu.ops import noise as jnoise
from llava_align_tpu.runners import blip_pope as jbp
from llava_align_tpu.runners import caption as jcap
from llava_align_tpu.runners.common import MockTokenizer as JMock
from llava_align_tpu_torch.evals.pope import load_jsonl
from llava_align_tpu_torch.models import instructblip as tblip
from llava_align_tpu_torch.ops import noise as tnoise
from llava_align_tpu_torch.runners import blip_pope as tbp
from llava_align_tpu_torch.runners import caption as tcap
from llava_align_tpu_torch.runners.common import MockTokenizer as TMock
from llava_align_tpu_torch.utils.jax_params import from_jax_params

# torch on one thread: the tiny models gain nothing from more, and a thread
# per core spins at every small op (tests/lavis_ref.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

torch.backends.cuda.matmul.allow_tf32 = False

TOL = 1e-5
OBJECTS = ["dog", "car", "person", "chair", "cat", "tree"]


@pytest.fixture(scope="module")
def models():
    jcfg = jblip.InstructBlipConfig.tiny()
    jp = jax.device_get(jblip.init(jax.random.PRNGKey(0), jcfg))
    return ((JMock(), JMock(), jp, jcfg, "random-instructblip"),
            (TMock(), TMock(), from_jax_params(jp, device="cpu"), tblip.InstructBlipConfig.tiny(),
             "random-instructblip"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("blip_runners")
    pope = root / "tiny_POPE_questions.jsonl"
    pope.write_text("".join(json.dumps({"question_id": i, "image": f"img_{i // 3}.jpg",
                                        "text": f"Is there a {OBJECTS[i]} in the image?",
                                        "label": "yes" if i % 2 == 0 else "no"}) + "\n" for i in range(6)))
    caps = root / "captions.jsonl"
    caps.write_text("".join(json.dumps({"image": f"cap_{i}.jpg", "image_id": i + 1}) + "\n" for i in range(2)))
    return {"pope": str(pope), "captions": str(caps)}


@pytest.fixture
def patched(models, monkeypatch):
    """Both packages' runners load the one tiny tree; both draw the noise
    of a step from one numpy eps."""
    jm, tm = models
    for mod, m in ((jbp, jm), (jcap, jm), (tbp, tm), (tcap, tm)):
        monkeypatch.setattr(mod, "load_blip_model", lambda *a, _m=m, **k: _m)
    H = jm[3].vision.image_size

    def eps(step):
        return np.random.default_rng(1000 + int(step)).standard_normal((1, 3, H, H)).astype(np.float32)

    def jax_noise(images, rng, noise_step):
        sqrt_ab, sqrt_1m_ab = (jnp.asarray(a) for a in jnoise.diffusion_schedule())
        t = int(noise_step)
        return (sqrt_ab[t] * images.astype(jnp.float32) + sqrt_1m_ab[t] * jnp.asarray(eps(t))).astype(images.dtype)

    def port_noise(images, noise_step, generator=None):
        return tnoise.add_diffusion_noise(images, noise_step, eps=torch.from_numpy(eps(noise_step)))

    monkeypatch.setattr(jbp, "add_diffusion_noise", jax_noise)
    monkeypatch.setattr(tbp, "add_diffusion_noise", port_noise)


def _pope_args(mod, qf, answers, **kw):
    args = mod.build_parser().parse_args(
        ["--model-path", "random:tiny", "--question-file", qf, "--answers-file", answers])
    args.synthetic_images = True
    args.max_new_tokens = 4
    args.temperature = 0.0  # greedy
    args.cd_alpha, args.cd_beta = 1.0, 0.1
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _assert_records_match(got, want, n):
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g.keys(), w.keys())
        for key in w:
            if key in ("naive", "none", "noise"):
                assert g[key].keys() == w[key].keys(), (w["question_id"], key)
                for tok in w[key]:
                    assert abs(g[key][tok] - w[key][tok]) <= TOL, (w["question_id"], key, tok)
            elif key == "logits_score":
                assert all(abs(a - b) <= TOL for a, b in zip(g[key], w[key]))
            else:
                assert g[key] == w[key], (w["question_id"], key)


@pytest.mark.parametrize("mode", [{}, {"use_cd": True, "noise_step": 500}], ids=["plain", "vcd"])
def test_blip_pope_records_equal_jax(patched, files, tmp_path, mode):
    paths = {}
    for name, mod, extra in (("jax", jbp, {}), ("port", tbp, {"device": "cpu"})):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        mod.run(_pope_args(mod, files["pope"], paths[name], calibrate=True, **extra, **mode))
    got, want = load_jsonl(paths["port"]), load_jsonl(paths["jax"])
    _assert_records_match(got, want, 6)
    assert all(r["naive"] and r["none"] and r["noise"] for r in got)


def test_qformer_text_keeps_sep_and_buckets(models):
    """The instruction cut to the Q-Former's 64 positions keeps its last id
    (the [SEP]), and the padded bucket is capped at that length."""
    cfg = models[1][3]
    tok = TMock()
    long = "x" * 100
    ids, mask = tbp.qformer_text(tok, long, cfg)
    raw = tok(long).input_ids
    assert ids.shape == mask.shape == (1, 64) and ids[0, -1] == raw[-1] and mask.sum() == 64
    ids, mask = tbp.qformer_text(tok, "a dog?", cfg)
    assert ids.shape == (1, 32) and mask.sum() == len(tok("a dog?").input_ids) and ids[0, mask[0] == 0].sum() == 0


@pytest.mark.parametrize("beams", [2, 5])
def test_caption_results_equal_jax(patched, files, tmp_path, beams):
    saved = {}
    for name, mod, extra in (("jax", jcap, []), ("port", tcap, ["--device", "cpu"])):
        out = tmp_path / name
        args = mod.build_parser().parse_args(
            ["--model-path", "random:tiny", "--question-file", files["captions"], "--result-dir", str(out),
             "--synthetic-images", "--num-beams", str(beams)] + extra)
        assert mod.run(args) == str(out)
        saved[name] = json.loads((out / "val_epoch0.json").read_text())
    assert saved["port"] == saved["jax"]
    assert [r["image_id"] for r in saved["port"]] == [1, 2]


@pytest.mark.parametrize("case", ["dist_auto", "w8a8"])
def test_blip_pope_refusals(patched, files, tmp_path, case, monkeypatch):
    """--dist auto, once refused, now runs over torch.distributed; without
    a launcher environment it answers in one process into the requested
    file, equal to a run without the flag. --quant w8a8, once refused, is
    now read by nothing, as in the JAX runner: the records equal the JAX
    runner's with the flag and the port's own without it."""
    answers = str(tmp_path / "a.jsonl")
    if case == "dist_auto":
        for name in ("RANK", "WORLD_SIZE"):
            monkeypatch.delenv(name, raising=False)
        plain = str(tmp_path / "plain.jsonl")
        assert tbp.run(_pope_args(tbp, files["pope"], answers, device="cpu", dist="auto")) == answers
        tbp.run(_pope_args(tbp, files["pope"], plain, device="cpu"))
        assert load_jsonl(answers) == load_jsonl(plain)
        return
    paths = {}
    for name, mod, extra in (("jax", jbp, {"quant": "w8a8"}), ("port", tbp, {"device": "cpu", "quant": "w8a8"}),
                             ("plain", tbp, {"device": "cpu"})):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        mod.run(_pope_args(mod, files["pope"], paths[name], calibrate=True, **extra))
    got = load_jsonl(paths["port"])
    _assert_records_match(got, load_jsonl(paths["jax"]), 6)
    assert got == load_jsonl(paths["plain"])


def test_load_blip_model(tmp_path, monkeypatch):
    import sys

    llm_tok, bert_tok, params, cfg, name = tbp.load_blip_model("random:tiny", device="cpu")
    assert cfg == tblip.InstructBlipConfig.tiny() and name == "random-instructblip"
    assert isinstance(llm_tok, TMock) and isinstance(bert_tok, TMock)
    assert params["llama"]["embed"].device.type == "cpu" and params["query_tokens"].shape == (4, 48)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tbp.load_blip_model(str(tmp_path), device="cpu")
