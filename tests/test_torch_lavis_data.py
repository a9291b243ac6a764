"""The LAVIS zoo's data path in the port (framework/processors.py's train,
CLIP and text processors, framework/randaugment.py, the image-text-pair,
retrieval and classification datasets and builders, and the
classification, pretraining and retrieval tasks) against the JAX
package's, on the CPU: the same seeded processors give the same arrays,
the builders the same samples and collated batches, and the tasks the
same metrics. (The copies' sources are held in tests/test_torch_copies.py.)
"""

import json

import numpy as np
import pytest
from PIL import Image

from llava_align_tpu.framework import datasets as _jd  # noqa: F401  (the registrations)
from llava_align_tpu.framework import processors as _jp  # noqa: F401
from llava_align_tpu.framework import randaugment as jra
from llava_align_tpu.framework.registry import registry as jreg
from llava_align_tpu_torch.framework import datasets as _td  # noqa: F401
from llava_align_tpu_torch.framework import processors as _tp  # noqa: F401
from llava_align_tpu_torch.framework import randaugment as tra
from llava_align_tpu_torch.framework.registry import registry as treg


def _image(seed: int, size=(40, 30)):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))


@pytest.mark.parametrize("name,kw", [("blip_image_train", {"image_size": 24, "seed": 3}),
                                     ("blip2_image_train", {"image_size": 24, "seed": 4}),
                                     ("clip_image_train", {"image_size": 24, "seed": 5}),
                                     ("clip_image_eval", {"image_size": 24}),
                                     ("blip_image_eval", {"image_size": 24})])
def test_image_processors_match_jax(name, kw):
    j, t = jreg.get_processor_class(name)(**kw), treg.get_processor_class(name)(**kw)
    for seed, size in ((0, (40, 30)), (1, (20, 50)), (2, (16, 16))):
        np.testing.assert_array_equal(t(_image(seed, size)), j(_image(seed, size)))


@pytest.mark.parametrize("name,kw", [("blip_caption", {"prompt": "a picture of ", "max_words": 5}),
                                     ("blip_question", {"max_words": 4})])
def test_text_processors_match_jax(name, kw):
    j, t = jreg.get_processor_class(name)(**kw), treg.get_processor_class(name)(**kw)
    for text in ("A DOG, on the (red) couch!!", "what  is  this?   a #cat; or :dog~ ... ", "\nplain\n"):
        assert t(text) == j(text)


def test_randaugment_tables_and_draws_match_jax():
    assert sorted(tra.OPS) == sorted(jra.OPS) and tra.BLIP_TRAIN_AUGS == jra.BLIP_TRAIN_AUGS
    assert (tra.MAX_LEVEL, tra.TRANSLATE_CONST, tra.REPLACE_VALUE) == (jra.MAX_LEVEL, jra.TRANSLATE_CONST,
                                                                       jra.REPLACE_VALUE)
    img = np.asarray(_image(6, (32, 24)))
    for seed in range(6):
        ops = {}
        for mod in (tra, jra):
            ops[mod] = mod.RandomAugment(2, 7, augs=list(mod.BLIP_TRAIN_AUGS), rng=np.random.default_rng(seed))(img)
        np.testing.assert_array_equal(ops[tra], ops[jra])


@pytest.fixture()
def ann_dir(tmp_path):
    cap = [{"image": "a.jpg", "caption": "a dog on a couch", "image_id": "x1"},
           {"image": "a.jpg", "caption": "a sleeping dog", "image_id": "x1"},
           {"image": "b.jpg", "caption": "a red bicycle", "image_id": "x2"}]
    (tmp_path / "cap.json").write_text(json.dumps(cap))
    ret = [{"image": "a.jpg", "caption": ["a dog on a couch", "a sleeping dog"]},
           {"image": "b.jpg", "caption": "a red bicycle"}]
    (tmp_path / "ret.json").write_text(json.dumps(ret))
    cls = [{"image": "a.jpg", "sentence": "a dog sits", "label": "yes"},
           {"image": "b.jpg", "text_input": "a red bike", "label": "no"}]
    (tmp_path / "cls.json").write_text(json.dumps(cls))
    return tmp_path


@pytest.mark.parametrize("builder,splits,extra", [
    ("retrieval", {"train": "cap.json", "test": "ret.json"}, {}),
    ("coco_retrieval", {"train": "cap.json"}, {}),
    ("image_text_pair", {"train": "cap.json"}, {}),
    ("conceptual_caption_3m", {"train": "cap.json"}, {}),
    ("multimodal_classification", {"train": "cls.json", "val": "cls.json"}, {"classnames": ["no", "yes"]}),
    ("snli_ve", {"train": "cls.json"}, {"classnames": ["no", "yes"]}),
])
def test_builders_match_jax(ann_dir, builder, splits, extra):
    from llava_align_tpu.framework.tasks import BaseTask as JTask
    from llava_align_tpu_torch.framework.tasks import BaseTask as TTask

    cfg = {builder: {"builder": builder, "synthetic_images": True, **extra,
                     "build_info": {s: {"ann_paths": [str(ann_dir / f)]} for s, f in splits.items()}}}
    proc = {"vis_processors": {"train": "blip_image_eval", "eval": "blip_image_eval"},
            "text_processors": {"train": "blip_caption", "eval": "blip_caption"}}

    def build(task_cls, reg):
        c = {k: dict(v) for k, v in cfg.items()}
        for k in c:
            c[k]["vis_processors"] = {s: reg.get_processor_class(n)(image_size=16) for s, n in
                                      proc["vis_processors"].items()}
            c[k]["text_processors"] = {s: reg.get_processor_class(n)() for s, n in proc["text_processors"].items()}
        return task_cls().build_datasets(c)[builder]

    j, t = build(JTask, jreg), build(TTask, treg)
    assert sorted(j) == sorted(t)
    for split in j:
        assert type(t[split]).__name__ == type(j[split]).__name__ and len(t[split]) == len(j[split])
        for attr in ("text", "image", "txt2img", "img2txt"):
            assert getattr(t[split], attr, None) == getattr(j[split], attr, None), attr
        rows_t = [t[split][i] for i in range(len(t[split]))]
        rows_j = [j[split][i] for i in range(len(j[split]))]
        bt, bj = t[split].collater(rows_t), j[split].collater(rows_j)
        assert sorted(bt) == sorted(bj)
        for k in bj:
            np.testing.assert_array_equal(np.asarray(bt[k]), np.asarray(bj[k]), err_msg=k)


def test_tasks_match_jax(tmp_path):
    from llava_align_tpu.framework import tasks as jt
    from llava_align_tpu_torch.framework import tasks as tt

    rng = np.random.default_rng(0)
    i2t, t2i = rng.standard_normal((4, 7)), rng.standard_normal((7, 4))
    img2txt = {0: [0, 1], 1: [2], 2: [3, 4, 5], 3: [6]}
    txt2img = {t: i for i, ts in img2txt.items() for t in ts}
    want = jt.RetrievalTask.report_metrics(i2t, t2i, txt2img, img2txt)
    assert tt.RetrievalTask.report_metrics(i2t, t2i, txt2img, img2txt) == want
    sims = lambda params, loader: (i2t, t2i)  # noqa: E731
    got = tt.RetrievalTask(sim_fn=sims).after_evaluation(tt.RetrievalTask(sim_fn=sims).evaluation(None, []),
                                                         txt2img=txt2img, img2txt=img2txt)
    assert got == want
    results = [{"question_id": i, "prediction": p, "target": g} for i, (p, g) in enumerate([(0, 0), (1, 0), (2, 2)])]
    kw = dict(result_dir=str(tmp_path))
    assert tt.MultimodalClassificationTask(**kw).after_evaluation(results) == \
        jt.MultimodalClassificationTask(**kw).after_evaluation(results)
    step = tt.MultimodalClassificationTask(predict_fn=lambda p, s: 1, **kw).valid_step(None, {"label": 1})
    assert step == [{"question_id": None, "prediction": 1, "target": 1}]
    pre = tt.ImageTextPretrainTask()
    assert pre.evaluation(None, [1, 2]) == [] and pre.after_evaluation([]) == {"agg_metrics": 0.0, "n": 0}
    for name in ("retrieval", "multimodal_classification", "image_text_pretrain"):
        assert treg.get_task_class(name).__name__ == jreg.get_task_class(name).__name__
