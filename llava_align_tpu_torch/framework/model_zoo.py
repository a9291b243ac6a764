"""Registry-assembled model zoo: the families the port carries (torch twin
of llava_align_tpu/framework/model_zoo.py).

LAVIS registers every model class with `@registry.register_model(arch)` so
tasks and configs assemble models by name; `BaseTask.build_model({"arch":
...})` resolves these entries. Each carries (params, cfg) and `make_engine`.
`model_path=None` (or "random[:...]") builds random weights on `device`
from the port's own generator (utils/synthetic; the random numbers are not
the JAX package's), else the checkpoint dir is converted. The device is
the GPU unless another is named.

Ported: llava (tiny / 7b / 13b), llava_mpt, qwen_vl, blip2_vicuna_instruct;
the LAVIS zoo's BLIP (blip_caption, blip_image_text_matching,
blip_feature_extractor), its variants (blip_retrieval, blip_vqa,
blip_classification, blip_nlvr, blip_pretrain), ALBEF (albef_retrieval,
albef_pretrain, albef_vqa, albef_classification, albef_nlvr,
albef_feature_extractor), CLIP (clip, clip_feature_extractor) and BLIP-2's
LAVIS entries (blip2, blip2_feature_extractor, blip2_image_text_matching,
blip2_opt, blip2_t5, blip2_t5_instruct), ALPRO (alpro_retrieval,
alpro_qa), gpt_dialogue, the composites pnp_vqa and img2prompt_vqa (BLIP-ITM
+ BLIP-caption + a T5), the FiD reader pnp_unifiedqav2_fid and
blip_diffusion; a random LAVIS entry is the tiny config, as in the JAX
zoo. And the front door: load_model, load_preprocess,
load_model_and_preprocess, ModelZoo. The registry equals the JAX zoo's
(tests/test_torch_lavis_convert.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from llava_align_tpu_torch.framework.registry import registry


class _ZooModel:
    arch: str = "base"

    def __init__(self, params, cfg):
        self.params = params
        self.cfg = cfg


def _random(model_path: Optional[str]) -> bool:
    return not model_path or model_path.startswith("random")


@registry.register_model("llava")
class LlavaModel(_ZooModel):
    """LLaVA-v1.5 (reference llava_llama.py capability)."""

    arch = "llava"

    def __init__(self, model_path: Optional[str] = None, size: str = "tiny", device=None, **kw):
        from llava_align_tpu_torch.config import LlavaConfig

        if not _random(model_path):
            from llava_align_tpu_torch.utils.hf_convert import load_llava_checkpoint

            params, cfg = load_llava_checkpoint(model_path, device=device)
        else:
            from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

            cfg = {
                "tiny": LlavaConfig.tiny,
                "7b": LlavaConfig.llava_v15_7b,
                "13b": LlavaConfig.llava_v15_13b,
            }[size]()
            params = build_random_llava_params(cfg, device=device)
        super().__init__(params, cfg)

    def make_engine(self, gen, **kw):
        from llava_align_tpu_torch.decoding.engine import DecodeEngine

        return DecodeEngine(self.params, self.cfg, gen, **kw)


@registry.register_model("llava_mpt")
class LlavaMptModel(_ZooModel):
    arch = "llava_mpt"

    def __init__(self, model_path: Optional[str] = None, device=None, **kw):
        from llava_align_tpu_torch.models import llava_mpt

        cfg = llava_mpt.LlavaMptConfig.tiny()
        params = llava_mpt.init(cfg, device=device)
        super().__init__(params, cfg)

    def make_engine(self, gen, **kw):
        from llava_align_tpu_torch.decoding.adapters import LlavaMptAdapter
        from llava_align_tpu_torch.decoding.engine import DecodeEngine

        return DecodeEngine(self.params, self.cfg, gen, adapter=LlavaMptAdapter(self.cfg), **kw)


@registry.register_model("qwen_vl")
class QwenVLModel(_ZooModel):
    arch = "qwen_vl"

    def __init__(self, model_path: Optional[str] = None, device=None, **kw):
        from llava_align_tpu_torch.models import qwen_vl

        if not _random(model_path):
            from llava_align_tpu_torch.utils.hf_convert import load_qwen_vl_checkpoint

            params, cfg = load_qwen_vl_checkpoint(model_path, device=device)
        else:
            from llava_align_tpu_torch.utils.synthetic import build_random_qwen_vl_params

            cfg = qwen_vl.QwenVLConfig.tiny()
            params = build_random_qwen_vl_params(cfg, device=device)
        super().__init__(params, cfg)

    def make_engine(self, gen, **kw):
        from llava_align_tpu_torch.decoding.adapters import QwenVLAdapter
        from llava_align_tpu_torch.decoding.engine import DecodeEngine

        return DecodeEngine(self.params, self.cfg, gen, adapter=QwenVLAdapter(self.cfg), **kw)


@registry.register_model("blip2_vicuna_instruct")
class InstructBlipModel(_ZooModel):
    arch = "blip2_vicuna_instruct"

    def __init__(self, model_path: Optional[str] = None, device=None, **kw):
        from llava_align_tpu_torch.models import instructblip

        if not _random(model_path):
            from llava_align_tpu_torch.utils.hf_convert import convert_instructblip, load_state_dict

            cfg = instructblip.InstructBlipConfig.vicuna7b()
            params = convert_instructblip(load_state_dict(model_path), cfg, device=device)
        else:
            cfg = instructblip.InstructBlipConfig.tiny()
            params = instructblip.init(cfg, device=device)
        super().__init__(params, cfg)

    def make_engine(self, gen, **kw):
        from llava_align_tpu_torch.decoding.adapters import InstructBlipAdapter
        from llava_align_tpu_torch.decoding.engine import DecodeEngine

        return DecodeEngine(self.params, self.cfg, gen, adapter=InstructBlipAdapter(self.cfg), **kw)


# ---------------------------------------------------------------------------
# the LAVIS zoo
# ---------------------------------------------------------------------------


def _blip_factory(arch_name: str):
    @registry.register_model(arch_name)
    class BlipModel(_ZooModel):
        arch = arch_name

        def __init__(self, model_path: Optional[str] = None, device=None, **kw):
            from llava_align_tpu_torch.models import blip as blip_mod

            if not _random(model_path):
                from llava_align_tpu_torch.utils.hf_convert import convert_blip, load_state_dict

                cfg = blip_mod.BlipConfig()
                params = convert_blip(load_state_dict(model_path), cfg, device=device)
            else:
                cfg = blip_mod.BlipConfig.tiny()
                params = blip_mod.init(cfg, device=device)
            super().__init__(params, cfg)

        def generate(self, pixels, prompt_ids, **kw):
            from llava_align_tpu_torch.models import blip as blip_mod

            return blip_mod.generate_caption(self.params, self.cfg, pixels, prompt_ids, **kw)

        def itm(self, pixels, text_ids, text_mask):
            from llava_align_tpu_torch.models import blip as blip_mod

            return blip_mod.itm_score(self.params, self.cfg, pixels, text_ids, text_mask)

        def extract_features(self, **kw):
            from llava_align_tpu_torch.models import blip as blip_mod

            return blip_mod.extract_features(self.params, self.cfg, **kw)

    BlipModel.__name__ = f"BlipModel_{arch_name}"
    return BlipModel


for _arch in ("blip_caption", "blip_image_text_matching", "blip_feature_extractor"):
    _blip_factory(_arch)


def _albef_factory(arch_name: str, variant: str):
    @registry.register_model(arch_name)
    class AlbefModel(_ZooModel):
        """ALBEF zoo entry (reference lavis/models/albef_models/*)."""

        arch = arch_name

        def __init__(self, model_path: Optional[str] = None, num_classes: int = 0, device=None, **kw):
            from llava_align_tpu_torch.models import albef as albef_mod

            if not _random(model_path):
                from llava_align_tpu_torch.models.blip import MedConfig
                from llava_align_tpu_torch.utils.hf_convert import convert_albef, load_state_dict

                if variant == "nlvr":
                    # albef_nlvr: an 18-layer encoder (6 text + 12 alternating fusion layers)
                    cfg = albef_mod.AlbefConfig(text=MedConfig(vocab_size=30522, num_layers=18, fusion_layer=6),
                                                num_classes=num_classes)
                else:
                    cfg = albef_mod.AlbefConfig(num_classes=num_classes)
                params = convert_albef(load_state_dict(model_path), cfg, variant=variant, device=device)
            else:
                cfg = albef_mod.AlbefConfig.tiny(
                    num_classes=num_classes or (2 if variant in ("classification", "nlvr") else 0),
                    nlvr=variant == "nlvr")
                params = albef_mod.init(cfg, variant=variant, device=device)
            self.variant = variant
            super().__init__(params, cfg)

        def predict_answers(self, pixels, q_ids, q_mask, answer_ids, answer_mask, **kw):
            from llava_align_tpu_torch.models import albef as albef_mod

            return albef_mod.rank_answers(self.params, self.cfg, pixels, q_ids, q_mask, answer_ids, answer_mask, **kw)

        def compute_sim_matrix(self, pixels, text_ids, text_mask, **kw):
            from llava_align_tpu_torch.models import albef as albef_mod

            return albef_mod.compute_sim_matrix(self.params, self.cfg, pixels, text_ids, text_mask, **kw)

        def extract_features(self, **kw):
            from llava_align_tpu_torch.models import albef as albef_mod

            return albef_mod.extract_features(self.params, self.cfg, **kw)

        def predict(self, *args):
            from llava_align_tpu_torch.models import albef as albef_mod

            if self.variant == "nlvr":
                return albef_mod.nlvr_forward(self.params, self.cfg, *args)
            return albef_mod.classify(self.params, self.cfg, *args)

        def train_step(self, m_params, state, generator, pixels, ids, mask, **kw):
            from llava_align_tpu_torch.models import albef as albef_mod

            fn = albef_mod.pretrain_train_step if self.variant == "pretrain" else albef_mod.retrieval_train_step
            return fn(self.params, m_params, state, self.cfg, generator, pixels, ids, mask, **kw)

    AlbefModel.__name__ = f"AlbefModel_{arch_name}"
    return AlbefModel


for _arch, _variant in (("albef_retrieval", "retrieval"), ("albef_pretrain", "pretrain"), ("albef_vqa", "vqa"),
                        ("albef_classification", "classification"), ("albef_nlvr", "nlvr"),
                        ("albef_feature_extractor", "feature")):
    _albef_factory(_arch, _variant)


def _clip_factory(arch_name: str):
    @registry.register_model(arch_name)
    class ClipModel(_ZooModel):
        """CLIP zoo entry (reference lavis/models/clip_models/model.py)."""

        arch = arch_name

        def __init__(self, model_path: Optional[str] = None, device=None, **kw):
            from llava_align_tpu_torch.models import clip as clip_mod

            if not _random(model_path):
                from llava_align_tpu_torch.utils.hf_convert import (
                    convert_clip_full,
                    convert_clip_openai,
                    load_state_dict,
                )

                cfg = clip_mod.ClipConfig()
                sd = load_state_dict(model_path)
                convert = convert_clip_openai if "visual.class_embedding" in sd else convert_clip_full
                params = convert(sd, cfg, device=device)
            else:
                cfg = clip_mod.ClipConfig.tiny()
                params = clip_mod.init(cfg, device=device)
            super().__init__(params, cfg)

        def encode_image(self, pixels):
            from llava_align_tpu_torch.models import clip as clip_mod

            return clip_mod.encode_image(self.params, self.cfg, pixels)

        def encode_text(self, ids):
            from llava_align_tpu_torch.models import clip as clip_mod

            return clip_mod.encode_text(self.params, self.cfg, ids)

        def extract_features(self, **kw):
            from llava_align_tpu_torch.models import clip as clip_mod

            return clip_mod.extract_features(self.params, self.cfg, **kw)

        def zero_shot_classifier(self, classnames, templates, tokenize):
            from llava_align_tpu_torch.models import clip as clip_mod

            return clip_mod.zero_shot_classifier(self.params, self.cfg, classnames, templates, tokenize)

        def predict(self, pixels, classifier):
            from llava_align_tpu_torch.models import clip as clip_mod

            return clip_mod.zero_shot_predict(self.params, self.cfg, pixels, classifier)

        def compute_sim_matrix(self, pixels, text_ids, text_mask=None, **kw):
            # text_mask taken for the retrieval archs' signature; CLIP pools
            # at the EOT position and needs none
            from llava_align_tpu_torch.models import clip as clip_mod

            return clip_mod.compute_sim_matrix(self.params, self.cfg, pixels, text_ids)

    ClipModel.__name__ = f"ClipModel_{arch_name}"
    return ClipModel


for _arch in ("clip", "clip_feature_extractor"):
    _clip_factory(_arch)


def _blip_variant_factory(arch_name: str, variant: str):
    @registry.register_model(arch_name)
    class BlipVariantModel(_ZooModel):
        """BLIP variant zoo entry (reference lavis/models/blip_models/*)."""

        arch = arch_name

        def __init__(self, model_path: Optional[str] = None, num_classes: int = 2, device=None, **kw):
            from llava_align_tpu_torch.models import blip as blip_base
            from llava_align_tpu_torch.models import blip_variants as bv_mod

            if not _random(model_path):
                from llava_align_tpu_torch.utils.hf_convert import (
                    convert_blip_nlvr,
                    convert_blip_variant,
                    load_state_dict,
                )

                sd = load_state_dict(model_path)
                if variant == "nlvr":
                    cfg = bv_mod.NlvrConfig(num_classes=num_classes)
                    params = convert_blip_nlvr(sd, cfg, device=device)
                else:
                    cfg = blip_base.BlipConfig()
                    params = convert_blip_variant(sd, cfg, variant, num_classes=num_classes, device=device)
            elif variant == "nlvr":
                cfg = bv_mod.NlvrConfig.tiny()
                params = bv_mod.init_nlvr(cfg, device=device)
            else:
                cfg = blip_base.BlipConfig.tiny()
                if variant == "vqa":
                    params = bv_mod.init_vqa(cfg, device=device)
                elif variant == "classification":
                    params = bv_mod.init_classification(cfg, num_classes, device=device)
                else:  # retrieval, pretrain (+ a decoder)
                    params = bv_mod.init_retrieval(cfg, device=device)
                    if variant == "pretrain":
                        params["decoder"] = blip_base.med_init(cfg.text, device=device, seed=7)
            self.variant = variant
            super().__init__(params, cfg)

        def predict_answers(self, *args, **kw):
            from llava_align_tpu_torch.models import blip_variants as bv_mod

            return bv_mod.vqa_rank_answers(self.params, self.cfg, *args, **kw)

        def generate(self, *args, **kw):
            from llava_align_tpu_torch.models import blip_variants as bv_mod

            return bv_mod.vqa_generate(self.params, self.cfg, *args, **kw)

        def predict(self, *args, **kw):
            from llava_align_tpu_torch.models import blip_variants as bv_mod

            if self.variant == "nlvr":
                return bv_mod.nlvr_forward(self.params, self.cfg, *args, **kw)
            return bv_mod.classify(self.params, self.cfg, *args, **kw)

        def compute_sim_matrix(self, pixels, text_ids, text_mask, **kw):
            from llava_align_tpu_torch.models import blip as blip_base

            if self.variant not in ("retrieval", "pretrain"):
                raise ValueError(f"compute_sim_matrix needs ITC projections; the {self.variant!r} variant has "
                                 "none (use blip_retrieval)")
            return blip_base.compute_sim_matrix(self.params, self.cfg, pixels, text_ids, text_mask, **kw)

    BlipVariantModel.__name__ = f"BlipVariantModel_{arch_name}"
    return BlipVariantModel


for _arch, _variant in (("blip_retrieval", "retrieval"), ("blip_vqa", "vqa"),
                        ("blip_classification", "classification"), ("blip_nlvr", "nlvr"),
                        ("blip_pretrain", "pretrain")):
    _blip_variant_factory(_arch, _variant)


def _blip2_stage1_factory(arch_name: str):
    @registry.register_model(arch_name)
    class Blip2Stage1Model(_ZooModel):
        """Stage-1 BLIP-2 (reference blip2_qformer.py, registered as 'blip2'
        and 'blip2_feature_extractor', and blip2_image_text_matching.py)."""

        arch = arch_name

        def __init__(self, model_path: Optional[str] = None, device=None, **kw):
            from llava_align_tpu_torch.models import blip2 as blip2_mod

            if not _random(model_path):
                from llava_align_tpu_torch.utils.hf_convert import convert_blip2_stage1, load_state_dict

                cfg = blip2_mod.Blip2QformerConfig()
                params = convert_blip2_stage1(load_state_dict(model_path), cfg, device=device)
            else:
                cfg = blip2_mod.Blip2QformerConfig.tiny()
                params = blip2_mod.init_stage1(cfg, device=device)
            super().__init__(params, cfg)

        def forward(self, images, text_ids, text_mask, **kw):
            from llava_align_tpu_torch.models import blip2 as blip2_mod

            if arch_name == "blip2_image_text_matching":
                return blip2_mod.match(self.params, self.cfg, images, text_ids, text_mask,
                                       match_head=kw.pop("match_head", "itm"))
            return blip2_mod.pretrain_forward(self.params, self.cfg, images, text_ids, text_mask, **kw)

        def generate(self, images, **kw):
            from llava_align_tpu_torch.models import blip2 as blip2_mod

            return blip2_mod.generate_caption(self.params, self.cfg, images, **kw)

        def extract_features(self, **kw):
            from llava_align_tpu_torch.models import blip2 as blip2_mod

            return blip2_mod.extract_features(self.params, self.cfg, **kw)

        def compute_sim_matrix(self, images, text_ids, text_mask, **kw):
            from llava_align_tpu_torch.models import blip2 as blip2_mod

            return blip2_mod.compute_sim_matrix(self.params, self.cfg, images, text_ids, text_mask, **kw)

    Blip2Stage1Model.__name__ = f"Blip2Stage1Model_{arch_name}"
    return Blip2Stage1Model


for _arch in ("blip2", "blip2_feature_extractor", "blip2_image_text_matching"):
    _blip2_stage1_factory(_arch)


def _blip2_lm_factory(arch_name: str):
    @registry.register_model(arch_name)
    class Blip2LmModel(_ZooModel):
        """BLIP-2 with an LM (reference blip2_opt.py, blip2_t5.py,
        blip2_t5_instruct.py; 'blip2_t5_instruct' feeds the instruction
        into the Q-Former)."""

        arch = arch_name

        def __init__(self, model_path: Optional[str] = None, device=None, **kw):
            from llava_align_tpu_torch.models import blip2 as blip2_mod

            is_opt = arch_name == "blip2_opt"
            if not _random(model_path):
                from llava_align_tpu_torch.utils.hf_convert import convert_blip2_opt, convert_blip2_t5, load_state_dict

                sd = load_state_dict(model_path)
                if is_opt:
                    cfg = blip2_mod.Blip2OptConfig()
                    params = convert_blip2_opt(sd, cfg, device=device)
                else:
                    cfg = blip2_mod.Blip2T5Config()
                    params = convert_blip2_t5(sd, cfg, device=device)
            elif is_opt:
                cfg = blip2_mod.Blip2OptConfig.tiny()
                params = blip2_mod.init_opt(cfg, device=device)
            else:
                cfg = blip2_mod.Blip2T5Config.tiny()
                params = blip2_mod.init_t5(cfg, device=device)
            super().__init__(params, cfg)

        def forward(self, images, *args, **kw):
            from llava_align_tpu_torch.models import blip2 as blip2_mod

            if arch_name == "blip2_opt":
                return blip2_mod.opt_forward_loss(self.params, self.cfg, images, *args, **kw)
            return blip2_mod.t5_forward_loss(self.params, self.cfg, images, *args, **kw)

        def generate(self, images, prompt_ids, **kw):
            from llava_align_tpu_torch.models import blip2 as blip2_mod

            if arch_name == "blip2_opt":
                raise NotImplementedError("blip2_opt generation runs through DecodeEngine with Blip2OptAdapter "
                                          "and precomputed_feats")
            return blip2_mod.t5_generate(self.params, self.cfg, images, prompt_ids, **kw)

        def predict_answers(self, images, prompt_ids, **kw):
            # blip2_t5.predict_answers: a greedy generate over the question prompt
            return self.generate(images, prompt_ids, **kw)

        def predict_class(self, images, input_ids, input_mask, cand_ids, qformer_text_ids=None,
                          qformer_text_mask=None, **kw):
            import numpy as np

            from llava_align_tpu_torch.models import blip2 as blip2_mod

            if arch_name == "blip2_opt":
                raise NotImplementedError("predict_class is a T5-instruct path")
            if arch_name == "blip2_t5_instruct" and qformer_text_ids is not None:
                q_emb = blip2_mod.encode_image_queries_instruct(self.params, self.cfg, images, qformer_text_ids,
                                                                qformer_text_mask)
            else:
                q_emb = blip2_mod.encode_image_queries(self.params, self.cfg, images)
            enc_hidden, enc_mask = blip2_mod.t5_encode_with_prefix(self.params, self.cfg, q_emb, input_ids,
                                                                   input_mask)
            losses = blip2_mod.t5_candidate_losses(self.params, self.cfg, enc_hidden, enc_mask, cand_ids, **kw)
            return np.argsort(losses.float().cpu().numpy(), axis=-1)

    Blip2LmModel.__name__ = f"Blip2LmModel_{arch_name}"
    return Blip2LmModel


for _arch in ("blip2_opt", "blip2_t5", "blip2_t5_instruct"):
    _blip2_lm_factory(_arch)


@registry.register_model("gpt_dialogue")
class GptDialogueModel(_ZooModel):
    """GPT dialogue (reference lavis/models/gpt_models/gpt_dialogue.py)."""

    arch = "gpt_dialogue"

    def __init__(self, model_path: Optional[str] = None, device=None, **kw):
        from llava_align_tpu_torch.models import gpt2 as gpt2_mod

        if not _random(model_path):
            from llava_align_tpu_torch.utils.hf_convert import convert_gpt_dialogue, load_state_dict

            cfg = gpt2_mod.GptDialogueConfig()
            params = convert_gpt_dialogue(load_state_dict(model_path), cfg, device=device)
        else:
            cfg = gpt2_mod.GptDialogueConfig.tiny()
            params = gpt2_mod.dialogue_init(cfg, device=device)
        super().__init__(params, cfg)

    def forward(self, **samples):
        from llava_align_tpu_torch.models import gpt2 as gpt2_mod

        return gpt2_mod.dialogue_forward(self.params, self.cfg, **samples)

    def generate(self, input_ids, video_fts, **kw):
        from llava_align_tpu_torch.models import gpt2 as gpt2_mod

        return gpt2_mod.dialogue_generate(self.params, self.cfg, input_ids, video_fts, **kw)


def _alpro_factory(arch_name: str, variant: str):
    @registry.register_model(arch_name)
    class AlproModel(_ZooModel):
        """ALPRO zoo entry (reference lavis/models/alpro_models/*)."""

        arch = arch_name

        def __init__(self, model_path: Optional[str] = None, num_classes: int = 0, device=None, **kw):
            from llava_align_tpu_torch.models import alpro as alpro_mod

            if not _random(model_path):
                from llava_align_tpu_torch.utils.hf_convert import convert_alpro, load_state_dict

                cfg = alpro_mod.AlproConfig(num_classes=num_classes)
                params = convert_alpro(load_state_dict(model_path), cfg, variant=variant, device=device)
            else:
                cfg = alpro_mod.AlproConfig.tiny(num_classes=num_classes or (2 if variant == "qa" else 0))
                params = alpro_mod.init(cfg, variant=variant, device=device)
            self.variant = variant
            super().__init__(params, cfg)

        def predict(self, video, ids, mask):
            from llava_align_tpu_torch.models import alpro as alpro_mod

            return alpro_mod.qa_logits(self.params, self.cfg, video, ids, mask)

        def compute_sim_matrix(self, videos, text_ids, text_mask, **kw):
            from llava_align_tpu_torch.models import alpro as alpro_mod

            return alpro_mod.compute_sim_matrix(self.params, self.cfg, videos, text_ids, text_mask, **kw)

    AlproModel.__name__ = f"AlproModel_{arch_name}"
    return AlproModel


for _arch, _variant in (("alpro_retrieval", "retrieval"), ("alpro_qa", "qa")):
    _alpro_factory(_arch, _variant)


def _composite(model_path: Optional[str], qa_key: str, itm_path, cap_path, qa_path, device):
    """(params, cfgs) of a BLIP-ITM + BLIP-caption + T5 composite from its
    checkpoints (the reference's from_config through
    load_model_and_preprocess), or None for a random one."""
    explicit = {k: v for k, v in (("itm", itm_path), ("cap", cap_path), (qa_key, qa_path)) if v}
    if _random(model_path) and len(explicit) < 3:
        return None
    from llava_align_tpu_torch.utils.hf_convert import load_blip_t5_composite

    return load_blip_t5_composite(model_path or "", qa_key=qa_key, paths=explicit or None, device=device)


@registry.register_model("pnp_vqa")
class PnpVqaModel(_ZooModel):
    """PnP-VQA composite (reference lavis/models/pnp_vqa_models/): BLIP-ITM +
    BLIP-caption + a UnifiedQAv2 T5 (pnp_vqa.py from_config :321-338)."""

    arch = "pnp_vqa"

    def __init__(self, model_path: Optional[str] = None, *, itm_path: Optional[str] = None,
                 cap_path: Optional[str] = None, qa_path: Optional[str] = None, block_num: int = 7, device=None,
                 **kw):
        from llava_align_tpu_torch.models import pnp_vqa as pnp_mod

        loaded = _composite(model_path, "qa", itm_path, cap_path, qa_path, device)
        if loaded is not None:
            params, cfgs = loaded
            cfg = pnp_mod.PnpVqaConfig(itm=cfgs["itm"], cap=cfgs["cap"], qa=cfgs["qa"], block_num=block_num)
        else:
            cfg = pnp_mod.PnpVqaConfig.tiny()
            params = pnp_mod.init(cfg, device=device)
        super().__init__(params, cfg)

    def predict_answers(self, *args, **kw):
        from llava_align_tpu_torch.models import pnp_vqa as pnp_mod

        return pnp_mod.predict_answers(self.params, self.cfg, *args, **kw)


@registry.register_model("img2prompt_vqa")
class Img2PromptModel(_ZooModel):
    """Img2Prompt composite (reference lavis/models/img2prompt_models/):
    BLIP-ITM + BLIP-caption + a T5 question generator."""

    arch = "img2prompt_vqa"

    def __init__(self, model_path: Optional[str] = None, *, itm_path: Optional[str] = None,
                 cap_path: Optional[str] = None, qg_path: Optional[str] = None, block_num: int = 7, device=None,
                 **kw):
        from llava_align_tpu_torch.models import img2prompt as i2p_mod

        loaded = _composite(model_path, "qg", itm_path, cap_path, qg_path, device)
        if loaded is not None:
            params, cfgs = loaded
            cfg = i2p_mod.Img2PromptConfig(itm=cfgs["itm"], cap=cfgs["cap"], qg=cfgs["qg"], block_num=block_num)
        else:
            cfg = i2p_mod.Img2PromptConfig.tiny()
            params = i2p_mod.init(cfg, device=device)
        super().__init__(params, cfg)

    def prompts_construction(self, *args, **kw):
        from llava_align_tpu_torch.models import img2prompt as i2p_mod

        return i2p_mod.prompts_construction(*args, **kw)


@registry.register_model("pnp_unifiedqav2_fid")
class PnpUnifiedQAv2FiDModel(_ZooModel):
    """The Fusion-in-Decoder QA reader alone (reference
    pnp_vqa_models/pnp_unifiedqav2_fid.py: a T5ForConditionalGeneration
    whose encoder encodes each context apart and fuses the states along
    the sequence)."""

    arch = "pnp_unifiedqav2_fid"

    def __init__(self, model_path: Optional[str] = None, device=None, **kw):
        from llava_align_tpu_torch.models.t5 import T5Config

        if not _random(model_path):
            from llava_align_tpu_torch.utils.hf_convert import _load_component_sd, convert_t5, t5_config_from_json

            sd, cfg_json = _load_component_sd(model_path)
            cfg = t5_config_from_json(cfg_json)
            params = convert_t5(sd, cfg, device=device)
        else:
            from llava_align_tpu_torch.utils.synthetic import build_random_t5_params

            cfg = T5Config.tiny()
            params = build_random_t5_params(cfg, device=device)
        super().__init__(params, cfg)

    def generate(self, context_ids, context_mask, **kw):
        from llava_align_tpu_torch.models import pnp_vqa as pnp_mod

        return pnp_mod.fid_generate(self.params, self.cfg, context_ids, context_mask, **kw)


@registry.register_model("blip_diffusion")
class BlipDiffusionModel(_ZooModel):
    """BLIP-Diffusion (reference lavis/models/blip_diffusion_models/): the
    reference's own layers (ctx-CLIP, the Q-Former subject embedding, the
    DDPM loss, the DDIM + CFG loop) at the tiny config; the UNet and the
    VAE are the caller's torch callables (the reference takes them from
    diffusers)."""

    arch = "blip_diffusion"

    def __init__(self, model_path: Optional[str] = None, device=None, **kw):
        from llava_align_tpu_torch.models import blip_diffusion as bd_mod

        cfg = bd_mod.BlipDiffusionConfig.tiny()
        super().__init__(bd_mod.init(cfg, device=device), cfg)

    def generate(self, *args, **kw):
        from llava_align_tpu_torch.models import blip_diffusion as bd_mod

        return bd_mod.generate(self.params, self.cfg, *args, **kw)

    def train_loss(self, *args, **kw):
        from llava_align_tpu_torch.models import blip_diffusion as bd_mod

        return bd_mod.train_loss(self.params, self.cfg, *args, **kw)


# ---------------------------------------------------------------------------
# the front door (reference lavis/models/__init__.py: load_model,
# load_preprocess, load_model_and_preprocess and the model_zoo listing)
# ---------------------------------------------------------------------------

# the default preprocess of each arch family (the reference's yaml
# `preprocess:` blocks), as the JAX zoo lists them
_DEFAULT_PREPROCESS: Dict[str, Dict[str, Dict[str, Optional[str]]]] = {
    "blip": {"vis": {"train": "blip_image_train", "eval": "blip_image_eval"},
             "text": {"train": "blip_caption", "eval": "blip_caption"}},
    "blip2": {"vis": {"train": "blip2_image_train", "eval": "blip_image_eval"},
              "text": {"train": "blip_caption", "eval": "blip_caption"}},
    "albef": {"vis": {"train": "blip_image_train", "eval": "blip_image_eval"},
              "text": {"train": "blip_caption", "eval": "blip_caption"}},
    "alpro": {"vis": {"train": "alpro_video_train", "eval": "alpro_video_eval"},
              "text": {"train": "blip_caption", "eval": "blip_caption"}},
    "clip": {"vis": {"train": "clip_image_train", "eval": "clip_image_eval"},
             "text": {"train": None, "eval": None}},
    # the GPT processors need a tokenizer (the port fetches none): without
    # one, building them raises and says what to pass
    "gpt": {"vis": {"train": "gpt_video_ft", "eval": "gpt_video_ft"},
            "text": {"train": "gpt_dialogue", "eval": "gpt_dialogue"}},
    "blip_diffusion": {"vis": {"train": "blip_diffusion_inp_image_train", "eval": "blip_diffusion_inp_image_eval"},
                       "text": {"train": "blip_caption", "eval": "blip_caption"}},
    "pnp": {"vis": {"train": None, "eval": "blip_image_eval"},
            "text": {"train": None, "eval": "blip_caption"}},
    "img2prompt": {"vis": {"train": None, "eval": "blip_image_eval"},
                   "text": {"train": None, "eval": "blip_caption"}},
}


def _preprocess_family(name: str) -> Optional[Dict[str, Dict[str, Optional[str]]]]:
    # the longer prefixes first: blip_diffusion and blip2 before blip
    for prefix in ("blip_diffusion", "blip2", "img2prompt", "pnp", "blip", "albef", "alpro", "clip", "gpt"):
        if name.startswith(prefix):
            return _DEFAULT_PREPROCESS[prefix]
    return None


def load_preprocess(config: Dict[str, Any]):
    """(vis_processors, txt_processors), each keyed train / eval, from a
    preprocess config {"vis_processor": {"train": {"name": ..., **kw},
    ...}, "text_processor": {...}}; a missing entry is the identity."""
    from llava_align_tpu_torch.framework import processors  # noqa: F401 (the registrations)

    def build(cfg):
        if not cfg:
            return lambda x: x
        cfg = dict(cfg)
        name = cfg.pop("name")
        cls = registry.get_processor_class(name)
        if cls is None:
            raise KeyError(f"unknown processor {name!r}")
        return cls(**cfg)

    vis_cfg = (config or {}).get("vis_processor") or {}
    txt_cfg = (config or {}).get("text_processor") or {}
    return ({k: build(vis_cfg.get(k)) for k in ("train", "eval")},
            {k: build(txt_cfg.get(k)) for k in ("train", "eval")})


def load_model(name: str, model_path: Optional[str] = None, device=None, **kw):
    """A registered model by name, on `device` (the GPU unless another is
    named); checkpoints load through the entry's model_path."""
    return registry.get_model_class(name)(model_path=model_path, device=device, **kw)


def load_model_and_preprocess(name: str, model_path: Optional[str] = None, device=None, **kw):
    """(model, vis_processors, txt_processors) with the family's default
    preprocess registrations (None, None for a family without them)."""
    model = load_model(name, model_path, device=device, **kw)
    fam = _preprocess_family(name)
    if fam is None:
        return model, None, None
    cfg = {"vis_processor": {k: ({"name": v} if v else None) for k, v in fam["vis"].items()},
           "text_processor": {k: ({"name": v} if v else None) for k, v in fam["text"].items()}}
    vis, txt = load_preprocess(cfg)
    return model, vis, txt


class ModelZoo:
    """The registered architectures as a table (reference ModelZoo; each
    arch's types collapse to one preset)."""

    def __init__(self):
        self.model_zoo = {name: ["default"] for name in registry.list("model")}

    def __str__(self):
        header = "=" * 50 + "\n" + f"{'Architectures':<30} {'Types'}\n" + "=" * 50
        rows = [f"{n:<30} {', '.join(t)}" for n, t in sorted(self.model_zoo.items())]
        return header + "\n" + "\n".join(rows)

    def __iter__(self):
        return iter(self.model_zoo.items())

    def __len__(self):
        return sum(len(v) for v in self.model_zoo.values())


model_zoo = ModelZoo()
