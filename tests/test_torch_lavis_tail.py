"""The port's copies of the JAX package's host-side tail, run beside the
originals on the same inputs (their sources are held equal in
tests/test_torch_copies.py): the prompt-to-prompt controllers
(models/ptp.py) through attention_with_hook, the download layer
(framework/download.py) with a fake opener (no URL is opened), the
rotating file logger (framework/logger.build_logger), and BLIP-Diffusion's
processors, dataset, blip_diffusion_finetune builder and
text-to-image-generation task. Every output equal."""

import hashlib
import io
import logging
import os
import zipfile

import numpy as np
import pytest

from llava_align_tpu.framework import datasets as jds
from llava_align_tpu.framework import download as jdl
from llava_align_tpu.framework import logger as jlog
from llava_align_tpu.framework import processors as jpr
from llava_align_tpu.framework import tasks as jtasks
from llava_align_tpu.models import ptp as jptp
from llava_align_tpu_torch.framework import download as tdl
from llava_align_tpu_torch.framework import logger as tlog
from llava_align_tpu_torch.framework import processors as tpr
from llava_align_tpu_torch.framework import tasks as ttasks
from llava_align_tpu_torch.framework.registry import registry as tregistry
from llava_align_tpu_torch.models import ptp as tptp


class WordTokenizer:
    """encode: [bos, one id per word, eos]; decode([id]) → the word."""

    def __init__(self):
        self.words = ["<bos>", "<eos>"]

    def encode(self, text):
        ids = []
        for w in text.split(" "):
            if w not in self.words:
                self.words.append(w)
            ids.append(self.words.index(w))
        return [0] + ids + [1]

    def decode(self, ids):
        return self.words[ids[0]]


def _ptp_run(ptp, hook_of, rng_seed: int = 0):
    """4 denoising steps of two attention sites (cross over 77 words, self
    over 16 positions) for a [uncond | cond] batch of 2 prompts x 2 heads,
    through attention_with_hook."""
    rng = np.random.default_rng(rng_seed)
    outs = []
    for _ in range(4):
        for is_cross, keys in ((True, ptp.MAX_NUM_WORDS), (False, 16)):
            q = rng.standard_normal((8, 16, 4)).astype(np.float32)
            k = rng.standard_normal((8, keys, 4)).astype(np.float32)
            v = rng.standard_normal((8, keys, 4)).astype(np.float32)
            outs.append(ptp.attention_with_hook(q, k, v, hook_of(is_cross), is_cross))
    return outs


@pytest.mark.parametrize("kind", ["replace", "refine", "store"])
def test_ptp_controllers_through_attention_with_hook_equal_jax(kind):
    prompts = ["a cat sits on the mat", "a dog sits on the mat"]
    results = []
    for ptp in (jptp, tptp):
        tok = WordTokenizer()
        if kind == "replace":
            ctrl = ptp.AttentionReplace(prompts, 4, 0.8, 0.4, tokenizer=tok)
        elif kind == "refine":
            ctrl = ptp.AttentionRefine([prompts[0], "a small dog sits on the mat"], 4, {"default_": 0.8, "dog": 0.5},
                                       (0.0, 0.4), tokenizer=tok)
        else:
            ctrl = ptp.AttentionStore()
        ptp.register_attention_control(ctrl, 2)
        outs = _ptp_run(ptp, lambda is_cross: ptp.make_attn_hook(ctrl, "up"))
        store = ctrl.get_average_attention() if kind == "store" else ctrl.attention_store
        results.append((outs, ctrl.cur_step, {k: [np.asarray(m) for m in v] for k, v in store.items()}))
    (j_outs, j_step, j_store), (t_outs, t_step, t_store) = results
    assert t_step == j_step == 4 and t_store.keys() == j_store.keys()
    assert len(t_store["up_cross"]) == 1 and len(t_store["up_self"]) == 1
    for got, want in zip(t_outs + [m for v in t_store.values() for m in v],
                         j_outs + [m for v in j_store.values() for m in v]):
        np.testing.assert_array_equal(got, want)
    # an edit changed the edited prompt's cross attention; the store alone did not
    plain = _ptp_run(tptp, lambda is_cross: tptp.make_attn_hook(None, "up"))
    assert any(not np.array_equal(a, b) for a, b in zip(t_outs, plain)) == (kind != "store")


def test_ptp_helpers_equal_jax():
    tok = WordTokenizer()
    text = "a photo of a sks dog"
    for word in ("dog", 1, "a"):
        np.testing.assert_array_equal(tptp.get_word_inds(text, word, tok), jptp.get_word_inds(text, word, tok))
    np.testing.assert_array_equal(tptp.get_equalizer(text, ("dog",), (2.0,), tok, num_subject_token=2),
                                  jptp.get_equalizer(text, ("dog",), (2.0,), tok, num_subject_token=2))
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(tptp._max_pool2d_3x3(x), jptp._max_pool2d_3x3(x))
    np.testing.assert_array_equal(tptp._interp_nearest(x, (12, 12)), jptp._interp_nearest(x, (12, 12)))
    assert tptp.MAX_NUM_WORDS == jptp.MAX_NUM_WORDS == 77


class FakeResponse(io.BytesIO):
    status = 200

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _opener(data: bytes, log: list):
    def opener(req, timeout=None):
        log.append(req.full_url)
        return FakeResponse(data)

    return opener


def _zip_bytes(names) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for n in names:
            z.writestr(n, f"content of {n}")
    return buf.getvalue()


def _tree(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def test_download_entry_with_a_fake_opener_equals_jax(tmp_path):
    """md5 verified and the archive extracted; an md5 mismatch raises and
    removes the file; a dry run and a manual entry touch nothing."""
    data = _zip_bytes(["val2014/img1.jpg", "val2014/img2.jpg"])
    md5 = hashlib.md5(data).hexdigest()
    for name, dl in (("jax", jdl), ("port", tdl)):
        root, log = str(tmp_path / name), []
        entry = dl.DownloadEntry("cocotest", "val", "http://x/val.zip", md5=md5, storage="images")
        out = dl.download_entry(entry, root, _opener=_opener(data, log))
        assert out == os.path.join(root, "cocotest", "images") and log == ["http://x/val.zip"]
        bad = dl.DownloadEntry("d", "x", "http://x/a.zip", md5="0" * 32)
        with pytest.raises(dl.DownloadUnavailable, match="md5 mismatch"):
            dl.download_entry(bad, root, _opener=_opener(data, log))
        assert not os.path.exists(os.path.join(root, "d", "download", "a.zip"))
        assert dl.download_entry(entry, root, dry_run=True, _opener=None) is None
        with pytest.raises(dl.ManualDownloadRequired):
            dl.download_entry(dl.entries_for("flickr30k")[0], root)
        assert dl.download_dataset("msrvtt", root, dry_run=True) == jdl.download_dataset("msrvtt", root,
                                                                                         dry_run=True)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") and len(_tree(tmp_path / "port")) == 2
    assert tdl.MANIFEST == [tdl.DownloadEntry(**vars(e)) for e in jdl.MANIFEST] and tdl.datasets() == jdl.datasets()


def test_builder_download_entries_equal_jax():
    for name in ("coco_caption", "msrvtt_retrieval", "flickr30k"):
        j = jds.registry.get_builder_class(name)({}).download_entries()
        t = tregistry.get_builder_class(name)({}).download_entries()
        assert [vars(e) for e in t] == [vars(e) for e in j] and t, name


def test_build_logger_writes_its_file(tmp_path):
    for name, lg in (("jax", jlog), ("port", tlog)):
        log = lg.build_logger(f"tail_test_{name}", "run.log", str(tmp_path / name))
        again = lg.build_logger(f"tail_test_{name}", "run.log", str(tmp_path / name))
        assert again is log and len(log.handlers) == 1
        assert isinstance(log.handlers[0], logging.handlers.TimedRotatingFileHandler)
        log.info("step %d done", 3)
        log.handlers[0].flush()
    got = (tmp_path / "port" / "run.log").read_text()
    want = (tmp_path / "jax" / "run.log").read_text()
    assert got.split(" | ", 1)[1] == "INFO | tail_test_port | step 3 done\n"
    assert want.split(" | ", 1)[1] == "INFO | tail_test_jax | step 3 done\n"


def test_blip_diffusion_data_path_equals_jax(tmp_path):
    """The blip_diffusion_finetune builder (registered in both registries)
    with the input, target and caption processors over two images: equal
    samples, the length times the repetition, the collated batch; the
    text-to-image-generation task builds from a run config."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for i, size in enumerate(((40, 30), (24, 36))):
        Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(tmp_path / f"img{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    batches = []
    for pr, reg in ((jpr, jds.registry), (tpr, tregistry)):
        procs = {"vis_processors": {"inp": pr.BlipDiffusionInputImageProcessor(image_size=16),
                                    "tgt": pr.BlipDiffusionTargetImageProcessor(image_size=24)},
                 "text_processors": {"eval": pr.BlipCaptionProcessor()}}
        builder = reg.get_builder_class("blip_diffusion_finetune")(
            {"images": {"storage": str(tmp_path)}, "subject_text": "Dog!"}, repetition=3, **procs)
        ds = builder.build()["train"]
        assert len(ds) == 6 and ds.len_without_repeat == 2
        samples = sorted((ds[i] for i in range(3)), key=lambda s: float(s["inp_image"].sum()))
        batches.append((samples, ds.collater(samples[:2])))
        run_cfg = {"task": "text-to-image-generation", "task_args": {"steps": 2}}
        task = reg.get_task_class("text-to-image-generation").setup_task(run_cfg)
        assert task.cfg == {"steps": 2, "run_cfg": run_cfg}
    (j_samples, j_batch), (t_samples, t_batch) = batches
    assert t_samples[0]["caption"] == j_samples[0]["caption"] == "a dog"
    assert t_samples[0]["inp_image"].shape == (3, 16, 16) and t_samples[0]["tgt_image"].shape == (3, 24, 24)
    for got, want in zip(t_samples, j_samples):
        assert got.keys() == want.keys()
        for k in ("inp_image", "tgt_image"):
            np.testing.assert_array_equal(got[k], want[k])
    assert t_batch.keys() == j_batch.keys()
    for k in t_batch:
        np.testing.assert_array_equal(np.asarray(t_batch[k]), np.asarray(j_batch[k]))
    assert issubclass(ttasks.TextToImageGenerationTask, ttasks.BaseTask)
    assert issubclass(jtasks.TextToImageGenerationTask, jtasks.BaseTask)
