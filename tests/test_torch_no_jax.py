"""llava_align_tpu_torch imports, and runs a tiny generate (int8) and a tiny
grouped shared-prefix decode (int4) on the CPU, with jax (and the JAX
package) blocked — the machine with the card has no jax."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import sys
for blocked in ("jax", "jaxlib", "llava_align_tpu"):
    sys.modules[blocked] = None  # any import of them now raises ImportError

import importlib, pkgutil
import numpy as np
import llava_align_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)

from llava_align_tpu_torch.config import GenerationConfig
from llava_align_tpu_torch.decoding.engine import DecodeEngine
from llava_align_tpu_torch.runners.common import build_prompt, load_model
from llava_align_tpu_torch.tokenization import tokenizer_image_token

lm = load_model("random:tiny", quant="int8", device="cpu")
ids = tokenizer_image_token(build_prompt("Is there a dog in the image?", "llava_v1")[0], lm.tokenizer)
image = np.random.default_rng(0).integers(0, 256, (3, 28, 28), dtype=np.uint8)
gen = GenerationConfig(max_new_tokens=4, do_sample=False, use_dd=True, use_dd_unk=True,
                       cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9)
out = DecodeEngine(lm.params, lm.cfg, gen).generate(ids, image)
assert out.num_generated == 4, out

lm4 = load_model("random:tiny", quant="int4", device="cpu")
assert "q4" in lm4.params["llama"]["layers"]["qkv"]
prompts = [tokenizer_image_token(build_prompt(q, "llava_v1")[0], lm4.tokenizer)
           for q in ("Is there a dog in the image?", "Is there a cat in the image?")]
p = DecodeEngine.common_token_prefix(prompts)
engine4 = DecodeEngine(lm4.params, lm4.cfg, gen)
outs = engine4.generate_batch_groups([(prompts[0][:p], [ids_[p:] for ids_ in prompts], image)] * 2)
assert [o.num_generated for o in outs] == [4] * 4, outs
assert outs[0].token_ids == engine4.generate(prompts[0], image).token_ids
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "llava_align_tpu"))]
assert not loaded, loaded
print("OK", len(names), out.token_ids)
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", CODE], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK"), proc.stdout
