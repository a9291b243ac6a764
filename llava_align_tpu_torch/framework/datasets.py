"""Dataset classes + registry-assembled builders (torch twin of
llava_align_tpu/framework/datasets.py; numpy only: the classes, builders
and build_datasets_for_model are copies, tests/test_torch_copies.py holds
them to the original's source and tests/test_torch_lavis_eval_data.py to
its behavior).

Ported: _load_annotations, _load_image (with the crc32 synthetic image for
a missing file), BaseAnnotationDataset, the caption, VQA, pair, retrieval,
classification, NLVR, video QA / retrieval / caption, AVSD dialogue and
ImageFolder datasets, BaseDatasetBuilder (its download methods through
framework/download), their builders with every named one, BLIP-Diffusion's
SubjectDrivenTextToImageDataset and its blip_diffusion_finetune builder,
and build_datasets_for_model (its video branch gives ALPRO's TimeSformer
the video processor).

Capability parity: the reference's vendored LAVIS dataset subsystem
(lavis/datasets/datasets/*.py and lavis/datasets/builders):
CaptionDataset remaps image_id → dense ids (caption_datasets.py:42-48).
Offline behavior: `synthetic_images=True` substitutes missing image
(and video) files with the same deterministic per-path noise the runners
use.
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


class VQADataset(BaseAnnotationDataset):
    """coco_vqa_datasets.py: per-question (answers, frequency weights)."""

    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        answer_weight: Dict[str, float] = {}
        for answer in ann["answer"]:
            answer_weight[answer] = answer_weight.get(answer, 0.0) + 1 / len(ann["answer"])
        return {
            "image": self._image(ann["image"]),
            "text_input": self.text_processor(ann["question"]),
            "answers": list(answer_weight.keys()),
            "weights": list(answer_weight.values()),
        }


class VQAEvalDataset(BaseAnnotationDataset):
    def __init__(self, *args, answer_list_path: Optional[str] = None, **kw):
        super().__init__(*args, **kw)
        self.answer_list = None
        if answer_list_path and os.path.exists(answer_list_path):
            self.answer_list = json.load(open(answer_list_path))

    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        return {
            "image": self._image(ann["image"]),
            "text_input": self.text_processor(ann["question"]),
            "question_id": ann["question_id"],
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


class NLVRDataset(BaseAnnotationDataset):
    """nlvr_datasets.py: two images + sentence + True/False label."""

    LABELS = {"True": 1, "False": 0, True: 1, False: 0, 1: 1, 0: 0}

    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        images = ann["images"]
        return {
            "image0": self._image(images[0]),
            "image1": self._image(images[1]),
            "text_input": self.text_processor(ann["sentence"]),
            "label": self.LABELS[ann["label"]],
        }


# ---------------------------------------------------------------------------
# builders (lavis/datasets/builders pattern: config → {split: dataset})
# ---------------------------------------------------------------------------


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
        # `dataset` names the raw-data manifest key (framework/download.py);
        # it is builder metadata, not a dataset-class kwarg. Named builders
        # (coco_caption, flickr30k, ...) carry a class-level default.
        self.dataset_name = kw.pop("dataset", None) or getattr(self, "DATASET", None)
        self.extra = kw

    def download_entries(self):
        """Manifest entries for fetching this builder's raw data
        (framework/download.py — the counterpart of the reference's
        lavis/datasets/download_scripts). The dataset key comes from the
        builder config's `dataset` field (e.g. dataset='coco')."""
        from llava_align_tpu_torch.framework import download

        return download.entries_for(self.dataset_name) if self.dataset_name else []

    def download(self, root: str, **kw):
        """Offline-safe fetch of this builder's dataset (skips cleanly when
        the network is unavailable; manual-flow sources are reported)."""
        from llava_align_tpu_torch.framework import download

        if not self.dataset_name:
            raise ValueError("builder config has no `dataset` key to download")
        return download.download_dataset(self.dataset_name, root, **kw)

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


@registry.register_builder("vqa")
class VQABuilder(BaseDatasetBuilder):
    train_cls = VQADataset
    eval_cls = VQAEvalDataset


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


@registry.register_builder("nlvr")
class NLVRBuilder(BaseDatasetBuilder):
    train_cls = NLVRDataset
    eval_cls = NLVRDataset


class VideoQADataset(BaseAnnotationDataset):
    """video_vqa_datasets.py capability: (video, question, answer-class).
    `video` in annotations points at a frame directory or a pre-extracted
    [T, H, W, 3] .npy (the reference decodes raw videos with decord, which
    is not installed in this environment)."""

    def __init__(self, *args, answer_list: Sequence[str] = (), **kw):
        super().__init__(*args, **kw)
        self.answer_list = list(answer_list)

    def _video(self, video_ref: str):
        path = os.path.join(self.vis_root, video_ref) if self.vis_root else video_ref
        if path.endswith(".npy") and os.path.exists(path):
            return self.vis_processor(np.load(path))
        if os.path.isdir(path) or os.path.exists(path):
            return self.vis_processor(path)
        if not self.synthetic_images:
            raise FileNotFoundError(path)
        rng = np.random.default_rng(zlib.crc32(video_ref.encode()))
        return self.vis_processor(
            rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
        )

    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        answer = ann["answer"]
        if self.answer_list and isinstance(answer, str):
            answer = self.answer_list.index(answer)
        return {
            "video": self._video(ann["video"]),
            "text_input": self.text_processor(ann["question"]),
            "answers": answer,
            "question_id": ann.get("question_id", ann["instance_id"]),
        }


class VideoRetrievalDataset(RetrievalEvalDataset):
    """retrieval over videos: same flattened .text/.txt2img ground truth,
    frames loaded like VideoQADataset."""

    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        video_ref = ann.get("video", ann.get("image"))
        path = os.path.join(self.vis_root, video_ref) if self.vis_root else video_ref
        if os.path.exists(path):
            src = path if not path.endswith(".npy") else np.load(path)
        elif self.synthetic_images:
            rng = np.random.default_rng(zlib.crc32(video_ref.encode()))
            src = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
        else:
            raise FileNotFoundError(path)
        return {"video": self.vis_processor(src), "index": index}


class VideoCaptionDataset(VideoQADataset):
    """video_caption_datasets.py VideoCaptionDataset: (video, caption) with
    dense image ids for ITC targets."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.img_ids: Dict[Any, int] = {}
        for ann in self.annotation:
            self.img_ids.setdefault(ann["image_id"], len(self.img_ids))

    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        return {
            "video": self._video(ann["video"]),
            "text_input": self.text_processor(ann["caption"]),
            "image_id": self.img_ids[ann["image_id"]],
        }


class VideoCaptionEvalDataset(VideoQADataset):
    """video_caption_datasets.py VideoCaptionEvalDataset."""

    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        return {
            "video": self._video(ann["video"]),
            "image_id": ann["image_id"],
            "instance_id": ann["instance_id"],
        }


@registry.register_builder("video_qa")
class VideoQABuilder(BaseDatasetBuilder):
    train_cls = VideoQADataset
    eval_cls = VideoQADataset


@registry.register_builder("video_retrieval")
class VideoRetrievalBuilder(BaseDatasetBuilder):
    train_cls = VideoRetrievalDataset
    eval_cls = VideoRetrievalDataset


@registry.register_builder("video_caption")
class VideoCaptionBuilder(BaseDatasetBuilder):
    train_cls = VideoCaptionDataset
    eval_cls = VideoCaptionEvalDataset


# ---------------------------------------------------------------------------
# named dataset builders (one per reference registration,
# lavis/datasets/builders/*.py): each binds a generic builder to its dataset's
# download-manifest key, so `registry.get_builder_class("coco_caption")`
# resolves exactly as in the reference.
# ---------------------------------------------------------------------------


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


for _name, _base, _ds in (
    # caption_builder.py
    ("coco_caption", CaptionBuilder, "coco"),
    ("nocaps", CaptionBuilder, "nocaps"),            # eval-only in reference
    ("msrvtt_caption", VideoCaptionBuilder, "msrvtt"),
    ("msvd_caption", VideoCaptionBuilder, "msvd"),
    ("vatex_caption", VideoCaptionBuilder, None),
    # image_text_pair_builder.py
    ("conceptual_caption_3m", ImageTextPairBuilder, "conceptual_captions"),
    ("conceptual_caption_12m", ImageTextPairBuilder, "conceptual_captions"),
    ("sbu_caption", ImageTextPairBuilder, "sbu"),
    ("vg_caption", ImageTextPairBuilder, "vg"),
    ("laion2B_multi", ImageTextPairBuilder, None),   # webdataset shards
    # vqa_builder.py
    ("coco_vqa", VQABuilder, "coco"),
    ("ok_vqa", VQABuilder, "coco"),
    ("aok_vqa", VQABuilder, "coco"),
    ("vg_vqa", VQABuilder, "vg"),
    ("gqa", VQABuilder, "gqa"),
    # retrieval_builder.py
    ("coco_retrieval", RetrievalBuilder, "coco"),
    ("flickr30k", RetrievalBuilder, "flickr30k"),
    ("msrvtt_retrieval", VideoRetrievalBuilder, "msrvtt"),
    ("didemo_retrieval", VideoRetrievalBuilder, "didemo"),
    # video_qa_builder.py
    ("msrvtt_qa", VideoQABuilder, "msrvtt"),
    ("msvd_qa", VideoQABuilder, "msvd"),
    # classification_builder.py ("nlvr" itself is registered above)
    ("snli_ve", MultimodalClassificationBuilder, None),
):
    _named_builder(_name, _base, _ds)


# ---------------------------------------------------------------------------
# dialogue (AVSD), imagefolder
# ---------------------------------------------------------------------------


def _expand_dialog_turns(ann_paths: Sequence[str], *, eval_mode: bool) -> List[dict]:
    """AVSD annotation expansion (reference dialogue_datasets.py:32-57 train,
    :88-113 eval): files carry {"dialogs": [...]}; train expands every turn
    into one sample whose `dialog` is the preceding context; eval keeps one
    sample per dialog with the LAST turn as the question/answer."""
    import copy

    annotation: List[dict] = []
    for ann_path in ann_paths:
        with open(ann_path) as f:
            dialogs = json.load(f)["dialogs"]
        for dialog in dialogs:
            all_turns = dialog["dialog"]
            if eval_mode:
                last = all_turns[-1]
                row = dict(dialog)
                row["dialog"] = all_turns[:-1]
                row["question"] = last["question"]
                row["answer"] = last["answer"]
                annotation.append(row)
            else:
                context: List[dict] = []
                for turn in all_turns:
                    row = copy.deepcopy(dialog)
                    row["dialog"] = copy.deepcopy(context)
                    row["question"] = turn["question"]
                    row["answer"] = turn["answer"]
                    annotation.append(row)
                    context.append(turn)
    return annotation


class AVSDDialDataset(BaseAnnotationDataset):
    """AVSD video-grounded dialogue (reference avsd_dialogue_datasets.py:16-89
    AVSDDialDataset): vis_processor is the gpt_video_ft processor called as
    (vis_root, vname); text_processor is gpt_dialogue. The collater pads the
    token streams, prepends the video segment to token_type_ids/labels
    (video labels = -1 = ignored), and concatenates the video and text
    attention masks — numpy throughout instead of torch.cat."""

    EVAL_MODE = False

    def __init__(self, vis_processor=None, text_processor=None, vis_root="",
                 ann_paths=(), **kw):
        # annotation format differs from the flat list loader
        self.vis_processor = vis_processor
        self.text_processor = text_processor
        self.vis_root = vis_root
        self.synthetic_images = kw.pop("synthetic_images", False)
        self.annotation = _expand_dialog_turns(ann_paths, eval_mode=self.EVAL_MODE)
        for i, ann in enumerate(self.annotation):
            ann.setdefault("instance_id", i)

    def __getitem__(self, index: int) -> dict:
        ann = self.annotation[index]
        vname = ann["image_id"]
        video = self.vis_processor(self.vis_root, vname)
        dialogue = self.text_processor(ann)
        return {
            "video_fts": video["video_fts"],
            "video_token_type_ids": video["token_type_ids"],
            "input_ids": dialogue["input_ids"],
            "token_type_ids": dialogue["token_type_ids"],
            "labels": dialogue["labels"],
            "image_id": ann["image_id"],
            "instance_id": ann["instance_id"],
        }

    def collater(self, samples: List[dict]) -> Dict[str, Any]:
        input_ids = self.text_processor.padding([s["input_ids"] for s in samples])
        labels = self.text_processor.padding([s["labels"] for s in samples], -1)
        video_fts = self.vis_processor.padding([s["video_fts"] for s in samples])
        token_type_ids = self.text_processor.padding(
            [s["token_type_ids"] for s in samples]
        )
        video_token_type_ids = self.text_processor.padding(
            [s["video_token_type_ids"] for s in samples]
        )
        token_type_ids = np.concatenate([video_token_type_ids, token_type_ids], axis=1)
        attn_mask = np.concatenate(
            [
                self.vis_processor.get_attention_mask(video_fts),
                self.text_processor.get_attention_mask(input_ids),
            ],
            axis=1,
        )
        video_labels = np.full(video_fts.shape[:2], -1, labels.dtype)
        labels = np.concatenate([video_labels, labels], axis=1)
        return {
            "input_ids": input_ids,
            "token_type_ids": token_type_ids,
            "labels": labels,
            "video_fts": video_fts,
            "attn_mask": attn_mask,
        }


class AVSDDialEvalDataset(AVSDDialDataset):
    """Eval split: one sample per dialog, last turn held out
    (avsd_dialogue_datasets.py:92-166)."""

    EVAL_MODE = True


@registry.register_builder("avsd_dialogue")
class AVSDDialBuilder(BaseDatasetBuilder):
    """reference dialogue_builder.py:17-22."""

    train_cls = AVSDDialDataset
    eval_cls = AVSDDialEvalDataset


class ImageFolderDataset(BaseAnnotationDataset):
    """Class-per-subdirectory image dataset (reference
    imagefolder_dataset.py:16-59, torchvision ImageFolder semantics: classes
    are the sorted subdirectory names, labels their indices). `classnames`
    optionally maps label indices to display names (the reference hardcodes
    the ImageNet-1k list in imagefolder_builder.py; pass it from config)."""

    IMG_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                ".tiff", ".webp")

    def __init__(self, vis_processor=None, vis_root="", classnames=(), **kw):
        self.vis_processor = vis_processor or (lambda x: np.asarray(x, np.float32))
        self.vis_root = vis_root
        self.synthetic_images = kw.pop("synthetic_images", False)
        self.classes = sorted(
            d for d in os.listdir(vis_root)
            if os.path.isdir(os.path.join(vis_root, d))
        )
        self.annotation = []
        for label, cls in enumerate(self.classes):
            cdir = os.path.join(vis_root, cls)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(self.IMG_EXTS):
                    path = os.path.join(cdir, fname)
                    self.annotation.append(
                        {"image": path, "label": label, "image_id": path}
                    )
        self.classnames = list(classnames)
        for i, ann in enumerate(self.annotation):
            ann.setdefault("instance_id", i)

    def __getitem__(self, index: int) -> dict:
        from PIL import Image

        ann = self.annotation[index]
        image = Image.open(ann["image"]).convert("RGB")
        return {
            "image": self.vis_processor(image),
            "label": ann["label"],
            "image_id": ann["image_id"],
            "instance_id": ann["instance_id"],
        }

    def displ_item(self, index: int) -> dict:
        sample, ann = self[index], self.annotation[index]
        name = (self.classnames[ann["label"]] if self.classnames
                else self.classes[ann["label"]])
        return {"file": ann["image"], "label": name, "image": sample["image"]}


@registry.register_builder("imagenet")
class ImageNetBuilder(BaseDatasetBuilder):
    """reference imagefolder_builder.py:15-60: per-split ImageFolder under
    vis_root/<split>; only train/val are valid split names."""

    train_cls = ImageFolderDataset
    eval_cls = ImageFolderDataset

    def build(self) -> Dict[str, Any]:
        datasets = {}
        for split, info in self.build_info.items():
            assert split in ("train", "val"), (
                f"Invalid split name {split}, must be one of 'train' and 'val'."
            )
            is_train = split == "train"
            info = dict(info)
            vis_root = info.pop("vis_root")
            if os.path.isdir(os.path.join(vis_root, split)):
                vis_root = os.path.join(vis_root, split)
            cls = self.train_cls if is_train else self.eval_cls
            datasets[split] = cls(
                self.vis_processors.get("train" if is_train else "eval"),
                vis_root=vis_root,
                **{**self.extra, **info},
            )
        return datasets


class SubjectDrivenTextToImageDataset:
    """BLIP-diffusion fine-tune dataset (reference
    subject_driven_t2i_dataset.py:15-72): every image in image_dir paired
    with the caption "a <subject>", processed through separate input/target
    image transforms; the dataset length is multiplied by `repetition` so an
    epoch loop yields enough steps."""

    def __init__(self, image_dir, subject_text, inp_image_processor,
                 tgt_image_processor, txt_processor, repetition=100000):
        self.subject = txt_processor(subject_text.lower())
        self.image_dir = image_dir
        self.inp_image_transform = inp_image_processor
        self.tgt_image_transform = tgt_image_processor
        self.text_processor = txt_processor
        exts = {"jpg", "png", "webp", "jpeg"}
        self.image_paths = [
            os.path.abspath(os.path.join(image_dir, p))
            for p in os.listdir(image_dir)
            if os.path.splitext(p)[1][1:].lower() in exts
        ]
        self.repetition = repetition

    def __len__(self) -> int:
        return len(self.image_paths) * self.repetition

    @property
    def len_without_repeat(self) -> int:
        return len(self.image_paths)

    @staticmethod
    def collater(samples: List[dict]) -> Dict[str, Any]:
        return BaseAnnotationDataset.collater(samples)

    def __getitem__(self, index: int) -> dict:
        from PIL import Image

        image_path = self.image_paths[index % len(self.image_paths)]
        image = Image.open(image_path).convert("RGB")
        caption = self.text_processor(f"a {self.subject}")
        return {
            "inp_image": self.inp_image_transform(image),
            "tgt_image": self.tgt_image_transform(image),
            "caption": caption,
            "subject_text": self.subject,
        }


@registry.register_builder("blip_diffusion_finetune")
class BlipDiffusionFinetuneBuilder(BaseDatasetBuilder):
    """reference text_to_image_generation_builder.py:16-41: train-only
    dataset assembled from build_info {images.storage, subject_text} with
    separate inp/tgt image processors (kw_processors in the reference)."""

    train_cls = SubjectDrivenTextToImageDataset

    def build(self) -> Dict[str, Any]:
        images = self.build_info["images"]
        image_dir = images["storage"] if isinstance(images, dict) else images
        dataset = self.train_cls(
            image_dir=image_dir,
            subject_text=self.build_info["subject_text"],
            inp_image_processor=self.vis_processors.get(
                "inp", self.vis_processors.get("train")
            ),
            tgt_image_processor=self.vis_processors.get(
                "tgt", self.vis_processors.get("eval")
            ),
            txt_processor=self.text_processors.get("eval", lambda s: s),
            **self.extra,
        )
        return {"train": dataset}


def build_datasets_for_model(task, model, datasets_cfg):
    """Builds every configured dataset, resolving processor NAMES through
    the registry (LAVIS behavior) and defaulting to an image/video
    processor sized to the model's tower."""
    from llava_align_tpu_torch.framework.processors import (
        AlproVideoEvalProcessor,
        BlipImageEvalProcessor,
    )
    from llava_align_tpu_torch.framework.registry import registry as _registry

    mcfg = model.cfg
    vision = getattr(mcfg, "vision", None) or getattr(
        getattr(mcfg, "base", None), "vision", None
    )
    video_cfg = getattr(mcfg, "video", None)
    if video_cfg is not None:  # ALPRO family: TimeSformer tower
        default_proc = AlproVideoEvalProcessor(
            image_size=video_cfg.image_size, n_frms=video_cfg.num_frames
        )
    else:
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

