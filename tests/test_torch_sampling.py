"""The port's decoding-configuration sweep (runners/sampling.py) against the
JAX package's, with sampled decodes held token for token across the two
frameworks.

The two engines draw their samples differently (jax.random.categorical in a
jitted lax.while_loop against torch.multinomial), so each engine module's
`sample_token` is replaced by a stand-in that draws by inverse CDF from one
shared table of uniforms, one uniform per sampled row, in call order. The
CDF is taken on the host in float64 from the fp32 warped logits each engine
hands over; the JAX stand-in reads them through
jax.experimental.io_callback(ordered=True), so it runs inside the jitted
while_loop. Both are patched before any engine is built (JAX engines cache
their jitted functions). Greedy calls (the scoring engines) keep argmax.

- the sweep's records under --grid smoke (default, temp_0.5, top_p_0.5,
  top_k_5) equal the JAX sweep's: ids and texts exactly, the top-k dicts
  within 1e-5, for --model-family llava (dual VDD, grouped), qwen, blip and
  --benchmark mmmu; the answers files are named alike;
- with --use_cd the sweep stops after its default point, as in JAX;
- the full grids equal the JAX package's;
- every draw that falls within 1e-5 of a CDF boundary (where fp32 logits
  that differ in the last bit could pick another token) is reported as a
  warning with its place.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from lavis_ref import one_torch_thread  # noqa: F401 (a fixture)
from llava_align_tpu.config import LlavaConfig as JCfg
from llava_align_tpu.decoding import sampler as jsampler
from llava_align_tpu.models import instructblip as jblip
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.models import qwen_vl as jqvl
from llava_align_tpu.runners import blip_pope as jbp
from llava_align_tpu.runners import common as jcommon
from llava_align_tpu.runners import mmmu as jmmmu
from llava_align_tpu.runners import pope as jpope
from llava_align_tpu.runners import qwen_pope as jqp
from llava_align_tpu.runners import sampling as jsampling
from llava_align_tpu_torch.config import LlavaConfig as TCfg
from llava_align_tpu_torch.decoding import sampler as tsampler
from llava_align_tpu_torch.evals.pope import load_jsonl
from llava_align_tpu_torch.models import instructblip as tblip
from llava_align_tpu_torch.models import qwen_vl as tqvl
from llava_align_tpu_torch.runners import blip_pope as tbp
from llava_align_tpu_torch.runners import common as tcommon
from llava_align_tpu_torch.runners import mmmu as tmmmu
from llava_align_tpu_torch.runners import pope as tpope
from llava_align_tpu_torch.runners import qwen_pope as tqp
from llava_align_tpu_torch.runners import sampling as tsampling
from llava_align_tpu_torch.utils.jax_params import from_jax_params

# torch on one thread: the tiny models gain nothing from more, and a thread
# per core spins at every small op (tests/lavis_ref.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
BOUNDARY = 1e-5  # a draw this close to a CDF boundary is reported
OBJECTS = ["dog", "car", "person", "chair", "cat", "tree"]
MMMU_SAMPLES = [
    {"id": "validation_Math_1", "subject": "Math", "question_type": "multiple-choice", "answer": "B",
     "all_choices": ["A", "B", "C", "D"], "index2ans": {"A": "1", "B": "2", "C": "3", "D": "4"},
     "final_input_prompt": "<image 1> How many dots? (A) 1 (B) 2 (C) 3 (D) 4", "image": "m1.png"},
    {"id": "validation_Art_2", "subject": "Art", "question_type": "open", "answer": ["blue", "azure"],
     "final_input_prompt": "<image 1> What colour is the sky?", "image": "a2.png"},
]
UNIFORMS = np.random.default_rng(20).random(100_000)


class InverseCdf:
    """One framework's stand-in state: its cursor into UNIFORMS and the
    near-boundary draws it made."""

    def __init__(self, name):
        self.name, self.cursor, self.near = name, 0, []

    def draw(self, warped: np.ndarray) -> np.ndarray:
        """fp32 warped logits [..., V] → int64 tokens [...], one uniform a row."""
        rows = np.asarray(warped, np.float32).reshape(-1, warped.shape[-1]).astype(np.float64)
        toks = []
        for row in rows:
            p = np.exp(row - row.max())
            cdf = np.cumsum(p)
            target = UNIFORMS[self.cursor] * cdf[-1]
            tok = min(int(np.searchsorted(cdf, target, side="right")), int(np.flatnonzero(p)[-1]))
            gap = np.abs(cdf[p > 0] - target).min() / cdf[-1]
            if gap < BOUNDARY:
                self.near.append((self.cursor, tok, float(gap)))
            toks.append(tok)
            self.cursor += 1
        return np.asarray(toks, np.int64).reshape(warped.shape[:-1])


@pytest.fixture
def inverse_cdf(monkeypatch):
    """Both engines' sample_token replaced by the stand-ins; returns their
    states."""
    jside, tside = InverseCdf("jax"), InverseCdf("port")
    j_orig, t_orig = jsampler.sample_token, tsampler.sample_token

    def jax_sample(rng, warped, do_sample=True):
        if not do_sample:
            return j_orig(rng, warped, do_sample)
        out = jax.ShapeDtypeStruct(warped.shape[:-1], jnp.int32)
        return io_callback(lambda w: jside.draw(np.asarray(w)).astype(np.int32), out, warped, ordered=True)

    def port_sample(generator, warped, do_sample=True):
        if not do_sample:
            return t_orig(generator, warped, do_sample)
        return torch.from_numpy(tside.draw(warped.float().cpu().numpy())).to(warped.device)

    monkeypatch.setattr(jsampler, "sample_token", jax_sample)
    monkeypatch.setattr(tsampler, "sample_token", port_sample)
    return jside, tside


@pytest.fixture(scope="module")
def models():
    """The tiny random tree of each family, as the JAX runner and the port
    runner load it."""
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCfg.tiny(vocab_size=512)))
    llava = (jcommon.LoadedModel(jcommon.MockTokenizer(), jp, JCfg.tiny(vocab_size=512), "random-tiny"),
             tcommon.LoadedModel(tcommon.MockTokenizer(), from_jax_params(jp, device="cpu"),
                                 TCfg.tiny(vocab_size=512), "random-tiny"))
    qcfg = jqvl.QwenVLConfig.tiny()
    qp = jax.device_get(jqvl.init(jax.random.PRNGKey(0), qcfg))
    qwen = ((jqp.QwenMockTokenizer(), qp, qcfg, "random-qwen-vl"),
            (tqp.QwenMockTokenizer(), from_jax_params(qp, device="cpu"), tqvl.QwenVLConfig.tiny(),
             "random-qwen-vl"))
    bcfg = jblip.InstructBlipConfig.tiny()
    bp = jax.device_get(jblip.init(jax.random.PRNGKey(0), bcfg))
    blip = ((jcommon.MockTokenizer(), jcommon.MockTokenizer(), bp, bcfg, "random-instructblip"),
            (tcommon.MockTokenizer(), tcommon.MockTokenizer(), from_jax_params(bp, device="cpu"),
             tblip.InstructBlipConfig.tiny(), "random-instructblip"))
    return {"llava": llava, "qwen": qwen, "blip": blip}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("sampling")
    pope = root / "tiny_POPE_questions.jsonl"
    pope.write_text("".join(json.dumps({"question_id": i, "image": f"img_{i // 3}.jpg",
                                        "text": f"Is there a {OBJECTS[i]} in the image?",
                                        "label": "yes" if i % 2 == 0 else "no"}) + "\n" for i in range(6)))
    mmmu = root / "mmmu_val.jsonl"
    mmmu.write_text("".join(json.dumps(s) + "\n" for s in MMMU_SAMPLES))
    return {"pope": str(pope), "mmmu": str(mmmu)}


def _patch_loaders(models, monkeypatch):
    (jl, tl), (jq, tq), (jb, tb) = models["llava"], models["qwen"], models["blip"]
    for mod, attr, m in ((jpope, "load_model", jl), (tpope, "load_model", tl), (jmmmu, "load_model", jl),
                         (tmmmu, "load_model", tl), (jqp, "load_qwen_model", jq), (tqp, "load_qwen_model", tq),
                         (jbp, "load_blip_model", jb), (tbp, "load_blip_model", tb)):
        monkeypatch.setattr(mod, attr, lambda *a, _m=m, **k: _m)


def _args(mod, qf, answers, **kw):
    args = mod.build_parser().parse_args(
        ["--model-path", "random:tiny", "--question-file", qf, "--answers-file", answers, "--grid", "smoke"])
    args.synthetic_images = True
    args.max_new_tokens = 4
    args.verbose = False
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _assert_records_match(got, want):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g.keys(), w.keys())
        for key in w:
            if key in ("naive", "none", "unk"):
                assert g[key].keys() == w[key].keys(), (key, w)
                for tok in w[key]:
                    assert abs(g[key][tok] - w[key][tok]) <= TOL, (key, tok)
            elif key == "logits_score":
                assert all(abs(a - b) <= TOL for a, b in zip(g[key], w[key]))
            else:
                assert g[key] == w[key], (key, g[key], w[key])


def _sweep_both(models, monkeypatch, files, tmp_path, **kw):
    """Both sweeps on one question file; returns (jax files, port files)."""
    _patch_loaders(models, monkeypatch)
    qf = files["mmmu"] if kw.get("benchmark") == "mmmu" else files["pope"]
    out = {}
    for name, mod, extra in (("jax", jsampling, {}), ("port", tsampling, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        out[name] = mod.run_sweep(_args(mod, qf, str(d / "answers_setting.jsonl"), **extra, **kw))
    return out["jax"], out["port"]


SWEEPS = {
    "llava": {"use_dd": True, "use_dd_unk": True, "cd_alpha": 1.0, "cd_beta": 0.1},
    "qwen": {"model_family": "qwen", "use_dd": True, "use_dd_unk": True},
    "blip": {"model_family": "blip"},
    "mmmu": {"benchmark": "mmmu", "use_dd": True, "use_dd_unk": True},
}


@pytest.mark.parametrize("sweep", list(SWEEPS))
def test_smoke_sweep_records_equal_jax(models, monkeypatch, files, tmp_path, inverse_cdf, sweep):
    want_files, got_files = _sweep_both(models, monkeypatch, files, tmp_path, **SWEEPS[sweep])
    names = ["default", "temp_0.5", "top_p_0.5", "top_k_5"]
    assert [os.path.basename(f) for f in got_files] == [os.path.basename(f) for f in want_files] == [
        f"answers_{n}.jsonl" for n in names]
    for g, w in zip(got_files, want_files):
        _assert_records_match(load_jsonl(g), load_jsonl(w))
    jside, tside = inverse_cdf
    assert jside.cursor == tside.cursor > 0  # both drew as many samples, in one order
    for side in (jside, tside):
        if side.near:
            warnings.warn(f"{side.name}: draws within {BOUNDARY} of a CDF boundary "
                          f"(uniform index, token, gap): {side.near}")


def test_use_cd_returns_after_the_default_point(models, monkeypatch, files, tmp_path, inverse_cdf):
    want_files, got_files = _sweep_both(models, monkeypatch, files, tmp_path, use_cd=True)
    assert [os.path.basename(f) for f in got_files] == [os.path.basename(f) for f in want_files] == [
        "answers_default.jsonl"]
    assert len(load_jsonl(got_files[0])) == 6


def test_grids_equal_jax():
    assert tsampling.TEMPERATURE_GRID == jsampling.TEMPERATURE_GRID and len(tsampling.TEMPERATURE_GRID) == 20
    assert tsampling.TOP_P_GRID == jsampling.TOP_P_GRID and len(tsampling.TOP_P_GRID) == 21
    assert tsampling.TOP_K_GRID == jsampling.TOP_K_GRID


def test_answers_file_needs_setting(tmp_path):
    args = _args(tsampling, "q.jsonl", str(tmp_path / "answers.jsonl"))
    with pytest.raises(ValueError, match="setting"):
        tsampling.run_sweep(args)
