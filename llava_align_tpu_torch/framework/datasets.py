"""Dataset classes + registry-assembled builders: the part the caption
training path reaches (torch twin of llava_align_tpu/framework/datasets.py;
numpy only: the classes, builders and build_datasets_for_model are copies,
tests/test_torch_copies.py holds _load_annotations to the original's
source and the rest to its behavior).

Ported: _load_annotations, _load_image (with the crc32 synthetic image for
a missing file), BaseAnnotationDataset, CaptionDataset,
CaptionEvalDataset, ImageTextPairDataset, RetrievalDataset,
RetrievalEvalDataset, MultimodalClassificationDataset, BaseDatasetBuilder
(without its download methods), the "caption", "image_text_pair",
"retrieval" and "multimodal_classification" builders with their named
ones, and build_datasets_for_model without its video branch. The VQA,
NLVR, video, dialogue, ImageNet and BLIP-Diffusion datasets and builders
are not ported yet.

Capability parity: the reference's vendored LAVIS dataset subsystem
(lavis/datasets/datasets/caption_datasets.py and lavis/datasets/builders):
CaptionDataset remaps image_id → dense ids (caption_datasets.py:42-48).
Offline behavior: `synthetic_images=True` substitutes missing image files
with the same deterministic per-path noise the runners use.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from llava_align_tpu_torch.framework.registry import registry


def _load_annotations(ann_paths: Sequence[str]) -> List[dict]:
    rows: List[dict] = []
    for path in ann_paths:
        with open(path) as f:
            head = f.read(1)
            f.seek(0)
            if head == "[":
                rows.extend(json.load(f))
            else:  # jsonl (tolerating trailing commas like framework/data.py)
                for line in f:
                    line = line.strip().rstrip(",")
                    if line:
                        rows.append(json.loads(line))
    return rows


def _load_image(
    vis_root: str, image_file: str, *, synthetic_ok: bool = False
):
    path = os.path.join(vis_root, image_file) if vis_root else image_file
    if os.path.exists(path):
        from PIL import Image

        return Image.open(path).convert("RGB")
    if not synthetic_ok:
        raise FileNotFoundError(path)
    from PIL import Image

    rng = np.random.default_rng(zlib.crc32(image_file.encode()))
    return Image.fromarray(
        rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
    )


class BaseAnnotationDataset:
    """lavis BaseDataset: annotation rows + (vis_processor, text_processor)."""

    def __init__(
        self,
        vis_processor: Optional[Callable] = None,
        text_processor: Optional[Callable] = None,
        vis_root: str = "",
        ann_paths: Sequence[str] = (),
        *,
        synthetic_images: bool = False,
    ):
        self.vis_processor = vis_processor or (lambda x: np.asarray(x, np.float32))
        self.text_processor = text_processor or (lambda s: s)
        self.vis_root = vis_root
        self.annotation = _load_annotations(ann_paths)
        self.synthetic_images = synthetic_images
        for i, ann in enumerate(self.annotation):
            ann.setdefault("instance_id", i)

    def __len__(self) -> int:
        return len(self.annotation)

    def _image(self, image_file: str):
        img = _load_image(
            self.vis_root, image_file, synthetic_ok=self.synthetic_images
        )
        return self.vis_processor(img)

    @staticmethod
    def collater(samples: List[dict]) -> Dict[str, Any]:
        """Stack array fields, list the rest (lavis default_collate shape)."""
        out: Dict[str, Any] = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if isinstance(vals[0], np.ndarray):
                out[key] = np.stack(vals)
            else:
                out[key] = vals
        return out


class CaptionDataset(BaseAnnotationDataset):
    """caption_datasets.py CaptionDataset: dense image ids for ITC targets."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.img_ids: Dict[Any, int] = {}
        for ann in self.annotation:
            self.img_ids.setdefault(ann["image_id"], len(self.img_ids))

    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        return {
            "image": self._image(ann["image"]),
            "text_input": self.text_processor(ann["caption"]),
            "image_id": self.img_ids[ann["image_id"]],
        }


class CaptionEvalDataset(BaseAnnotationDataset):
    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        return {
            "image": self._image(ann["image"]),
            "image_id": ann["image_id"],
            "instance_id": ann["instance_id"],
        }


class ImageTextPairDataset(BaseAnnotationDataset):
    """image_text_pair_datasets.py (pretraining pairs)."""

    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        return {
            "image": self._image(ann["image"]),
            "text_input": self.text_processor(ann["caption"]),
        }


class RetrievalDataset(CaptionDataset):
    """retrieval_datasets.py train split — caption rows + instance ids."""

    def __getitem__(self, index: int) -> dict:
        sample = super().__getitem__(index)
        sample["instance_id"] = self.annotation[index]["instance_id"]
        return sample


class RetrievalEvalDataset(BaseAnnotationDataset):
    """retrieval_datasets.py:79-112: flattened multi-caption ground truth."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.text: List[str] = []
        self.image: List[str] = []
        self.txt2img: Dict[int, int] = {}
        self.img2txt: Dict[int, List[int]] = {}
        txt_id = 0
        for img_id, ann in enumerate(self.annotation):
            self.image.append(ann.get("image", ann.get("video")))
            self.img2txt[img_id] = []
            captions = ann["caption"]
            if isinstance(captions, str):
                captions = [captions]
            for caption in captions:
                self.text.append(self.text_processor(caption))
                self.img2txt[img_id].append(txt_id)
                self.txt2img[txt_id] = img_id
                txt_id += 1

    def __getitem__(self, index: int) -> dict:
        return {
            "image": self._image(self.annotation[index]["image"]),
            "index": index,
        }


class MultimodalClassificationDataset(BaseAnnotationDataset):
    """multimodal_classification_datasets.py: (image, sentence, label)."""

    def __init__(self, *args, classnames: Sequence[str] = (), **kw):
        super().__init__(*args, **kw)
        self.classnames = list(classnames)

    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        label = ann["label"]
        if self.classnames and isinstance(label, str):
            label = self.classnames.index(label)
        return {
            "image": self._image(ann["image"]),
            "text_input": self.text_processor(ann.get("sentence", ann.get("text_input", ""))),
            "label": label,
            "instance_id": ann["instance_id"],
        }



class BaseDatasetBuilder:
    """lavis BaseDatasetBuilder capability: build every configured split with
    the right (train/eval) dataset class and processors. `build_info` maps
    split name → {"ann_paths": [...], "vis_root": str, ...extra}."""

    train_cls = BaseAnnotationDataset
    eval_cls = BaseAnnotationDataset

    def __init__(
        self,
        build_info: Dict[str, Dict[str, Any]],
        vis_processors: Optional[Dict[str, Callable]] = None,
        text_processors: Optional[Dict[str, Callable]] = None,
        **kw,
    ):
        self.build_info = build_info
        self.vis_processors = vis_processors or {}
        self.text_processors = text_processors or {}
        # `dataset` names the raw-data manifest key (the JAX package's
        # framework/download.py; not ported); it is builder metadata, not a dataset-class kwarg. Named builders
        # (coco_caption, flickr30k, ...) carry a class-level default.
        self.dataset_name = kw.pop("dataset", None) or getattr(self, "DATASET", None)
        self.extra = kw

    def build(self) -> Dict[str, Any]:
        datasets = {}
        for split, info in self.build_info.items():
            is_train = split == "train"
            cls = self.train_cls if is_train else self.eval_cls
            key = "train" if is_train else "eval"
            info = dict(info)
            ann_paths = info.pop("ann_paths")
            vis_root = info.pop("vis_root", "")
            datasets[split] = cls(
                self.vis_processors.get(key),
                self.text_processors.get(key),
                vis_root,
                ann_paths,
                **{**self.extra, **info},
            )
        return datasets


@registry.register_builder("caption")
class CaptionBuilder(BaseDatasetBuilder):
    train_cls = CaptionDataset
    eval_cls = CaptionEvalDataset


@registry.register_builder("retrieval")
class RetrievalBuilder(BaseDatasetBuilder):
    train_cls = RetrievalDataset
    eval_cls = RetrievalEvalDataset


@registry.register_builder("image_text_pair")
class ImageTextPairBuilder(BaseDatasetBuilder):
    train_cls = ImageTextPairDataset
    eval_cls = ImageTextPairDataset


@registry.register_builder("multimodal_classification")
class MultimodalClassificationBuilder(BaseDatasetBuilder):
    train_cls = MultimodalClassificationDataset
    eval_cls = MultimodalClassificationDataset



def _named_builder(name: str, base: type, dataset_key: Optional[str]):
    @registry.register_builder(name)
    class NamedBuilder(base):
        DATASET = dataset_key

    NamedBuilder.__name__ = f"Builder_{name}"
    NamedBuilder.__doc__ = (
        f"Reference builder '{name}' "
        f"(lavis/datasets/builders — thin named binding of {base.__name__}"
        + (f"; raw data manifest key '{dataset_key}'" if dataset_key else "")
        + ")."
    )
    return NamedBuilder


# the named builders of the ported bases (the JAX package's list, in its order)
for _name, _base, _ds in (
    # caption_builder.py
    ("coco_caption", CaptionBuilder, "coco"),
    ("nocaps", CaptionBuilder, "nocaps"),            # eval-only in the reference
    # image_text_pair_builder.py
    ("conceptual_caption_3m", ImageTextPairBuilder, "conceptual_captions"),
    ("conceptual_caption_12m", ImageTextPairBuilder, "conceptual_captions"),
    ("sbu_caption", ImageTextPairBuilder, "sbu"),
    ("vg_caption", ImageTextPairBuilder, "vg"),
    ("laion2B_multi", ImageTextPairBuilder, None),   # webdataset shards
    # retrieval_builder.py
    ("coco_retrieval", RetrievalBuilder, "coco"),
    ("flickr30k", RetrievalBuilder, "flickr30k"),
    # classification_builder.py
    ("snli_ve", MultimodalClassificationBuilder, None),
):
    _named_builder(_name, _base, _ds)


def build_datasets_for_model(task, model, datasets_cfg):
    """Builds every configured dataset, resolving processor NAMES through
    the registry (LAVIS behavior) and defaulting to an image processor
    sized to the model's tower (the JAX package's video branch, for
    ALPRO's TimeSformer, is not ported)."""
    from llava_align_tpu_torch.framework.processors import BlipImageEvalProcessor

    mcfg = model.cfg
    vision = getattr(mcfg, "vision", None) or getattr(
        getattr(mcfg, "base", None), "vision", None
    )
    default_proc = BlipImageEvalProcessor(
        image_size=getattr(vision, "image_size", 224)
    )

    def resolve(proc):
        if isinstance(proc, str):
            cls = registry.get_processor_class(proc)
            if cls is None:
                raise KeyError(f"unknown processor {proc!r}")
            return cls()
        return proc

    out_cfg = {}
    for name, dcfg in datasets_cfg.items():
        dcfg = dict(dcfg)
        procs = dcfg.get("vis_processors")
        if procs is None:
            dcfg["vis_processors"] = {"train": default_proc, "eval": default_proc}
        else:
            dcfg["vis_processors"] = {k: resolve(v) for k, v in procs.items()}
        if "text_processors" in dcfg:
            dcfg["text_processors"] = {
                k: resolve(v) for k, v in dcfg["text_processors"].items()
            }
        out_cfg[name] = dcfg
    return task.build_datasets(out_cfg)
