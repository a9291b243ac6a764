"""The port's utility tail against the JAX package's, on the CPU:

- utils/profiling: PhaseTimer's report (its phases and counts, exactly as
  the JAX timer's over the same phases), trace() a no-op on a falsy dir
  and a Chrome trace of the block otherwise;
- utils/checkpoint_tools: resize_token_embeddings (fp32 within 1e-5, bf16
  within one bf16 ulp of the row mean, its refusals), merge_lora,
  apply_projector_only, make_delta and apply_delta (exact, on numpy and
  torch state dicts);
- utils/moderation: violates_moderation with a client that flags, passes
  and raises;
- framework/native and framework/data.JsonlDataset: lines, lengths, long
  lines, missing lines and files, the prefetcher, the json-list and
  fallback paths, exactly as the JAX package's; the library built under
  build/native/;
- framework/tasks.PopeTask, registered as "pope": the evaluation flow and
  its metrics;
- the five helpers: models/llava.forward_multimodal (fp32 logits within
  1e-5, text-only and with images) and text_only_plan,
  decoding/sampler.combine_contrast_branches, decoding/engine.
  branch_token_ids and models/llama.param_count;
- utils/parity_check: the CLI on tests/ckpt_fixture.py's checkpoint, text
  and --image, at --tol 1e-3, and the tol gate failing on a planted
  conversion bug, as tests/test_parity_check_cli.py holds the JAX one.
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

TOL = 1e-5


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_phase_timer_report_and_trace(tmp_path):
    from llava_align_tpu.utils import profiling as jprof

    from llava_align_tpu_torch.utils import profiling as tprof

    timers = (jprof.PhaseTimer(), tprof.PhaseTimer())
    for timer in timers:
        for name in ("encode", "decode", "decode", "score"):
            with timer.phase(name, sync=name != "score"):
                torch.ones(4).sum()
    reports = [t.report() for t in timers]
    assert [sorted(r) for r in reports] == [["decode", "encode", "score"]] * 2
    for k in reports[0]:
        assert sorted(reports[1][k]) == sorted(reports[0][k]) == ["count", "mean_s", "total_s"]
        assert reports[1][k]["count"] == reports[0][k]["count"]
        assert reports[1][k]["total_s"] >= 0 and reports[1][k]["mean_s"] == reports[1][k]["total_s"] / reports[1][k]["count"]

    with tprof.trace(None), tprof.trace(""):  # falsy: nothing written
        torch.ones(2) + 1
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones((8, 8)) @ torch.ones((8, 8))
    events = json.loads((tmp_path / "tr" / tprof.TRACE_FILE).read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# checkpoint tools, moderation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_token_embeddings_matches_jax(dtype):
    import jax.numpy as jnp
    from llava_align_tpu.utils import checkpoint_tools as jct

    from llava_align_tpu_torch.utils import checkpoint_tools as tct

    rng = np.random.default_rng(0)
    tree = {"embed": rng.normal(size=(10, 8)).astype(np.float32), "lm_head": rng.normal(size=(10, 8)).astype(np.float32),
            "final_norm": np.ones(8, np.float32)}
    jt = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in tree.items()}
    want, got = jct.resize_token_embeddings(jt, 13), tct.resize_token_embeddings(tt, 13)
    assert got["final_norm"] is tt["final_norm"]
    for k in ("embed", "lm_head"):
        w, g = np.asarray(want[k].astype(jnp.float32)), got[k].float().numpy()
        assert g.shape == w.shape == (13, 8) and got[k].dtype == tt[k].dtype
        np.testing.assert_array_equal(g[:10], w[:10])
        # the fp32 row mean, summed in another order; rounded to bf16 it
        # may land one ulp (2^-8 relative) apart
        atol = TOL if dtype == "float32" else 2.0**-8 * np.abs(w[10:]).max()
        np.testing.assert_allclose(g[10:], w[10:], rtol=0, atol=atol)
    assert tct.resize_token_embeddings(tt, 10)["embed"] is tt["embed"]
    with pytest.raises(ValueError, match="shrink"):
        tct.resize_token_embeddings(tt, 9)
    with pytest.raises(ValueError, match="quantizing"):
        tct.resize_token_embeddings(dict(tt, embed={"q": 0, "s": 0}), 12)


def test_state_dict_tools_match_jax():
    from llava_align_tpu.utils import checkpoint_tools as jct

    from llava_align_tpu_torch.utils import checkpoint_tools as tct

    rng = np.random.default_rng(1)
    W = rng.normal(size=(8, 6)).astype(np.float32)
    base = {"model.layers.0.self_attn.q_proj.weight": W, "model.norm.weight": rng.normal(size=6).astype(np.float32)}
    lora = {"base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight": rng.normal(size=(2, 6)).astype(np.float32),
            "base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight": rng.normal(size=(8, 2)).astype(np.float32),
            "base_model.model.mm_projector.0.weight": np.ones((3, 3), np.float32)}
    target = {"model.layers.0.self_attn.q_proj.weight": rng.normal(size=(8, 6)).astype(np.float32),
              "model.embed_tokens.weight": rng.normal(size=(5, 6)).astype(np.float32)}
    proj = {"model.mm_projector.0.weight": np.ones((3,), np.float32)}

    def same(a, b):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    as_torch = lambda sd: {k: torch.from_numpy(v) for k, v in sd.items()}  # noqa: E731
    for conv in (lambda sd: sd, as_torch):  # numpy and torch state dicts
        for kw in ({}, {"scaling": 0.5}, {"lora_alpha": 4.0}):
            same(tct.merge_lora(conv(base), conv(lora), **kw), jct.merge_lora(base, lora, **kw))
        same(tct.apply_projector_only(conv(base), conv(proj)), jct.apply_projector_only(base, proj))
        delta = tct.make_delta(conv(base), conv(target))
        same(delta, jct.make_delta(base, target))
        same(tct.apply_delta(conv(base), conv(delta)), jct.apply_delta(base, delta))
    with pytest.raises(KeyError, match="LoRA target"):
        tct.merge_lora({}, lora)


def test_moderation_matches_jax():
    from llava_align_tpu.utils.moderation import violates_moderation as jmod

    from llava_align_tpu_torch.utils.moderation import violates_moderation as tmod

    def raising(text):
        raise RuntimeError("no service")

    for client in (lambda t: "bad" in t, lambda t: 0, raising):
        for text in ("a bad word", "fine"):
            assert tmod(text, client) == jmod(text, client)


# ---------------------------------------------------------------------------
# the native loader, JsonlDataset, PopeTask
# ---------------------------------------------------------------------------


def test_native_jsonl_and_prefetcher_match_jax(tmp_path):
    from llava_align_tpu.framework import native as jnative

    from llava_align_tpu_torch.framework import native as tnative

    assert tnative.load_library() is not None and jnative.load_library() is not None
    so = tnative.library_path()
    assert so.exists() and so.parent.parent.name == "native" and so.parent.parent.parent.name == "build"
    p = tmp_path / "d.jsonl"
    rows = [{"question_id": i, "text": "x" * (i % 7)} for i in range(50)] + [{"question_id": 50, "p": "y" * 200_000}]
    p.write_text("".join(json.dumps(r) + "\n" for r in rows) + "\n")
    j, t = jnative.NativeJsonl(str(p)), tnative.NativeJsonl(str(p))
    assert len(t) == len(j) == 51
    assert [t.line(i) for i in range(51)] == [j.line(i) for i in range(51)]
    assert list(t) == list(j) == rows
    for i in (-1, 51):
        with pytest.raises(IndexError):
            t.line(i)
    t.close()
    with pytest.raises(FileNotFoundError):
        tnative.NativeJsonl(str(tmp_path / "missing.jsonl"))

    files = []
    for i in range(6):
        f = tmp_path / f"f{i}.bin"
        f.write_bytes(bytes([i]) * (1000 + i))
        files.append(str(f))
    files.append(str(tmp_path / "absent.bin"))
    got = []
    for mod in (jnative, tnative):
        pf = mod.NativePrefetcher(num_threads=3)
        tickets = [pf.submit(f) for f in files]
        got.append([pf.take(tk) for tk in tickets])
        pf.close()
    assert got[1] == got[0] and got[1][2] == bytes([2]) * 1002 and got[1][-1] == b""


def test_jsonl_dataset_matches_jax(tmp_path):
    from llava_align_tpu.framework.data import JsonlDataset as JDataset

    from llava_align_tpu_torch.framework.data import JsonlDataset as TDataset

    rows = [{"question_id": i, "text": f"q{i}"} for i in range(7)]
    jl, js = tmp_path / "q.jsonl", tmp_path / "q.json"
    jl.write_text("".join(json.dumps(r) + "\n" for r in rows) + "\n")
    js.write_text(json.dumps(rows))
    transform = lambda r: (r["question_id"], r["text"].upper())  # noqa: E731
    for path, native, kw in ((jl, True, {}), (jl, False, {"use_native": False}), (js, False, {})):
        for tf in (None, transform):
            t, j = TDataset(str(path), tf, **kw), JDataset(str(path), tf, **kw)
            assert t.native is native
            assert len(t) == len(j) == 7
            assert [t[i] for i in range(7)] == [j[i] for i in range(7)]


def test_pope_task_matches_jax():
    from llava_align_tpu.framework.tasks import PopeTask as JTask

    from llava_align_tpu_torch.framework.registry import registry
    from llava_align_tpu_torch.framework.tasks import BaseTask, PopeTask

    assert registry.get_task_class("pope") is PopeTask and issubclass(PopeTask, BaseTask)
    samples = [{"question_id": i, "text": f"Is there a thing #{i}?", "label": ["yes", "no"][i % 2]} for i in range(8)]
    answers = ["Yes", "No", "No", "No", "yes, there is", "No", "Yes", "I am not sure"]

    def gen(params, sample):
        return answers[sample["question_id"]]

    out = []
    for cls in (JTask, PopeTask):
        task = cls(generate_fn=gen)
        results = task.evaluation(None, samples, log_freq=100)
        out.append((results, task.after_evaluation(results)))
    assert out[1] == out[0]
    assert out[1][1]["agg_metrics"] == out[1][1]["f1"]


# ---------------------------------------------------------------------------
# the five helpers
# ---------------------------------------------------------------------------


def test_forward_multimodal_and_text_only_plan_match_jax():
    import jax
    import jax.numpy as jnp
    from llava_align_tpu.config import LlavaConfig as JC
    from llava_align_tpu.models import llava as jllava

    from llava_align_tpu_torch.config import LlavaConfig as TC
    from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX as S
    from llava_align_tpu_torch.models import llava as tllava
    from llava_align_tpu_torch.utils.jax_params import from_jax_params
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    jcfg, tcfg = JC.tiny(vocab_size=64), TC.tiny(vocab_size=64)
    jp = _numpy(build_random_llava_params(tcfg, device="cpu", seed=2))
    tp = from_jax_params(jp, device="cpu")
    H = tcfg.vision.image_size
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, 3, H, H)).astype(np.float32)
    # (ids, JAX's images, the port's: one case passes its image unbatched)
    cases = [([1, 5, 7, 9], None, None, 8), ([1, 5, S, 7, 9], images[:1], images[0], 16),
             ([1, S, 5, S, 9], images, images, 24)]
    # one jitted program a case (op by op, JAX compiles each op of it apart)
    jfwd = jax.jit(lambda p, ids, im, pad: jllava.forward_multimodal(p, jcfg, list(ids), im, pad, attn_impl="xla"),
                   static_argnums=(1, 3))
    for ids, jim, tim, pad in cases:
        want, wl = jfwd(jp, tuple(ids), None if jim is None else jnp.asarray(jim), pad)
        with torch.inference_mode():
            got, gl = tllava.forward_multimodal(tp, tcfg, ids, None if tim is None else torch.from_numpy(tim), pad)
        assert gl == wl and got.shape == want.shape == (pad, 64) and got.dtype == torch.float32
        np.testing.assert_allclose(got[:gl].numpy(), np.asarray(want)[:wl], rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="special image tokens"):
        tllava.forward_multimodal(tp, tcfg, [1, S, 5], torch.from_numpy(images), 16)
    for ids in ([1, 5, S, 7], [], [S]):
        w, g = jllava.text_only_plan(ids, 8), tllava.text_only_plan(ids, 8)
        for k in ("tokens", "tok_gather", "img_gather", "is_image"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
        assert g.length == w.length


def test_contrast_branches_branch_ids_and_param_count_match_jax():
    import jax.numpy as jnp
    from llava_align_tpu.decoding import engine as jengine
    from llava_align_tpu.decoding import sampler as jsampler
    from llava_align_tpu.models import llama as jllama

    from llava_align_tpu_torch.config import LlamaConfig as TL
    from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX as S
    from llava_align_tpu_torch.decoding import engine as tengine
    from llava_align_tpu_torch.decoding import sampler as tsampler
    from llava_align_tpu_torch.models import llama as tllama
    from llava_align_tpu_torch.ops.quant import quantize_llama_params
    from llava_align_tpu_torch.utils.synthetic import build_random_llama_params

    logits = np.random.default_rng(4).normal(size=(3, 11)).astype(np.float32)
    for n in (0, 1, 2):
        (wm, wc), (gm, gc) = (jsampler.combine_contrast_branches(jnp.asarray(logits), n),
                              tsampler.combine_contrast_branches(torch.from_numpy(logits), n))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        assert (gc is None) == (wc is None) == (n == 0)
        if n:
            np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=0, atol=TOL)
    for kind in ("main", "cd", "unk", "none"):
        ids = [1, 5, S, 7, S, 9]
        assert tengine.branch_token_ids(ids, kind) == jengine.branch_token_ids(ids, kind)
    with pytest.raises(ValueError):
        tengine.branch_token_ids([1], "other")
    tree = build_random_llama_params(TL.tiny(vocab_size=97), device="cpu")
    for t in (tree, quantize_llama_params(tree, fuse=True)):  # int8: codes and scales, as JAX counts them
        assert tllama.param_count(t) == jllama.param_count(_numpy(t)) > 0


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


# ---------------------------------------------------------------------------
# parity_check, on tests/ckpt_fixture.py's checkpoint
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _small_vision(monkeypatch, vision_layers: int = 4, image_size: int = 112):
    """The port's config_from_hf for the reduced-width fixture (the real
    ClipVisionConfig is ViT-L/336), as ckpt_fixture.small_vision_config
    patches the JAX package's."""
    from ckpt_fixture import VD, VF

    from llava_align_tpu_torch.config import ClipVisionConfig
    from llava_align_tpu_torch.utils import hf_convert

    orig = hf_convert.config_from_hf

    def small_cfg(hf, dtype=torch.bfloat16):
        cfg = orig(hf, dtype)
        vision = ClipVisionConfig(image_size=image_size, patch_size=14, hidden_size=VD, intermediate_size=VF,
                                  num_layers=vision_layers, num_heads=4, select_layer=cfg.vision.select_layer,
                                  select_feature=cfg.vision.select_feature, dtype=dtype)
        return dataclasses.replace(cfg, vision=vision)

    monkeypatch.setattr(hf_convert, "config_from_hf", small_cfg)
    yield


@pytest.fixture(scope="module")
def parity_ckpt(tmp_path_factory):
    pytest.importorskip("safetensors.numpy")
    pytest.importorskip("transformers")
    from ckpt_fixture import build_tiny_llava_checkpoint
    from PIL import Image

    d = tmp_path_factory.mktemp("llava_ckpt")
    build_tiny_llava_checkpoint(d, vision_layers=4, image_size=112, with_tokenizer=True)
    img = d / "img.png"
    Image.fromarray(np.random.default_rng(7).integers(0, 256, (112, 112, 3), dtype=np.uint8)).save(img)
    return d, img


def _parity(args, capsys):
    from llava_align_tpu_torch.utils.parity_check import main

    rc = main(["--prompt", "Is there a dog in the image?", "--dtype", "float32", "--tol", "1e-3",
               "--device", "cpu", *args])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_parity_check_text_and_image_pass(parity_ckpt, capsys, monkeypatch):
    """One run compares both towers: the text logits within the JAX CLI's
    1e-3 with the top-1 and top-10 agreeing, the image features within
    1e-4 of their RMS (64 patch features at the text width)."""
    d, img = parity_ckpt
    with _small_vision(monkeypatch):
        rc, report = _parity(["--model-path", str(d), "--image", str(img)], capsys)
    assert rc == 0
    t, v = report["text_logits"], report["vision_projector_feats"]
    assert t["max_abs_diff"] < 1e-3 and t["top1_match"] and t["top10_overlap"] >= 9
    assert v["rel_max_diff"] < 1e-4 and v["shape"][:2] == [1, 64]


def test_parity_check_tol_gate_fails_on_conversion_bug(parity_ckpt, capsys, monkeypatch):
    """A corrupted weight on disk would reach both sides; a conversion bug
    reaches the port's only: one q weight perturbed after loading must
    push the text comparison past --tol and exit 1."""
    from llava_align_tpu_torch.utils import hf_convert

    d, _ = parity_ckpt
    orig = hf_convert.load_llava_checkpoint

    def corrupting_load(path, dtype=torch.bfloat16, device=None):
        params, cfg = orig(path, dtype, device)
        params["llama"]["layers"]["q"][0] += 0.5
        return params, cfg

    monkeypatch.setattr(hf_convert, "load_llava_checkpoint", corrupting_load)
    with _small_vision(monkeypatch):
        rc, report = _parity(["--model-path", str(d)], capsys)
    assert rc == 1 and report["text_logits"]["max_abs_diff"] > 1e-3
