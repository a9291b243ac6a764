"""Registry-assembled model zoo: the families the port carries (torch twin
of llava_align_tpu/framework/model_zoo.py).

LAVIS registers every model class with `@registry.register_model(arch)` so
tasks and configs assemble models by name; `BaseTask.build_model({"arch":
...})` resolves these entries. Each carries (params, cfg) and `make_engine`.
`model_path=None` (or "random[:...]") builds random weights on `device`
from the port's own generator (utils/synthetic; the random numbers are not
the JAX package's), else the checkpoint dir is converted. The device is
the GPU unless another is named.

Ported: llava (tiny / 7b / 13b), llava_mpt, qwen_vl, blip2_vicuna_instruct.
The LAVIS zoo (BLIP, ALBEF, CLIP, ALPRO, BLIP-2's LAVIS entries, PNP-VQA,
...) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

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
