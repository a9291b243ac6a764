"""llava_align_tpu_torch imports, and runs a tiny generate (int8), a tiny
lockstep generate_batch, a tiny grouped shared-prefix decode (int4), the
POPE runner and its scorer on a question file it writes, VCD through each
entry point, a tiny checkpoint written here as .safetensors and loaded,
the MME and MMMU runners and scorers, the Qwen-VL and InstructBLIP
runners, the W8A8 and int8 KV-cache modes, the sampling sweep, the bias
probe and the judge pipeline, LLaVA-MPT and BLIP-2 OPT generates, BLIP-2
T5's t5_generate and a stage-1 caption, the train CLI (2 epochs and a
resume; the four LAVIS archs' train steps built) and the LAVIS zoo, the
parallel dry run on 2 spawned ranks (parallel/*), every microbenchmark twin (at rehearsal size) and the utility tail (the native
loader, PopeTask, profiling, the checkpoint tools, moderation) on the CPU,
with jax (and the JAX package) blocked — the machine with the card has no
jax — and, for the slice's modules, with safetensors and transformers
blocked too (the port must not need them). The subprocesses run four at a
time, each on one thread."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import sys
for blocked in ("jax", "jaxlib", "llava_align_tpu", "safetensors", "transformers"):
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

from llava_align_tpu_torch.ops.quant import quantize_llama_params

def quantized(lm, bits):  # random:tiny loads in float; quantize as the POPE runner does
    lm.params["llama"] = quantize_llama_params(lm.params["llama"], bits=bits)
    return lm

lm = quantized(load_model("random:tiny", quant="int8", device="cpu"), 8)
assert "q" in lm.params["llama"]["layers"]["qkv"]
ids = tokenizer_image_token(build_prompt("Is there a dog in the image?", "llava_v1")[0], lm.tokenizer)
image = np.random.default_rng(0).integers(0, 256, (3, 28, 28), dtype=np.uint8)
gen = GenerationConfig(max_new_tokens=4, do_sample=False, use_dd=True, use_dd_unk=True,
                       cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9)
out = DecodeEngine(lm.params, lm.cfg, gen).generate(ids, image)
assert out.num_generated == 4, out

lm4 = quantized(load_model("random:tiny", quant="int4", device="cpu"), 4)
assert "q4" in lm4.params["llama"]["layers"]["qkv"]
prompts = [tokenizer_image_token(build_prompt(q, "llava_v1")[0], lm4.tokenizer)
           for q in ("Is there a dog in the image?", "Is there a cat in the image?")]
p = DecodeEngine.common_token_prefix(prompts)
engine4 = DecodeEngine(lm4.params, lm4.cfg, gen)
outs = engine4.generate_batch_groups([(prompts[0][:p], [ids_[p:] for ids_ in prompts], image)] * 2)
assert [o.num_generated for o in outs] == [4] * 4, outs
assert outs[0].token_ids == engine4.generate(prompts[0], image).token_ids
outs = engine4.generate_batch([(prompts[0], image), (prompts[1], None)])
assert [o.num_generated for o in outs] == [4, 4], outs
assert outs[0].token_ids == engine4.generate(prompts[0], image).token_ids

import json, os, tempfile
from llava_align_tpu_torch.evals.pope import load_jsonl, main as score_main
from llava_align_tpu_torch.runners import pope
d = tempfile.mkdtemp()
qf, af = os.path.join(d, "q_POPE.jsonl"), os.path.join(d, "answers.jsonl")
with open(qf, "w") as f:
    for i in range(4):
        f.write(json.dumps({"question_id": i, "image": f"img_{i // 2}.jpg", "label": ["yes", "no"][i % 2],
                            "text": f"Is there a {['dog', 'cat'][i % 2]} in the image?"}) + "\n")
args = pope.build_parser().parse_args([
    "--model-path", "random:tiny", "--device", "cpu", "--quant", "int8", "--question-file", qf,
    "--answers-file", af, "--use_dd", "--use_dd_unk", "--max_new_tokens", "3", "--temperature", "0",
    "--synthetic-images", "--calibrate", "--no-group-by-image", "--batch-size", "2"])
pope.run(args)
recs = load_jsonl(af)
assert [r["question_id"] for r in recs] == [0, 1, 2, 3] and all("none" in r and "unk" in r for r in recs)
import contextlib, io
report = io.StringIO()
with contextlib.redirect_stdout(report):
    assert score_main([qf, af]) == 0
assert report.getvalue().startswith("Precision:") and "[none_unk]" in report.getvalue()

# VCD through each entry point (int8 tree)
gen_cd = GenerationConfig(max_new_tokens=4, do_sample=False, use_cd=True, use_dd=True, use_dd_unk=True,
                          cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9)
engine_cd = DecodeEngine(lm.params, lm.cfg, gen_cd)
assert engine_cd.kinds == ["main", "cd", "none"]
assert engine_cd.generate(ids, image).num_generated == 4
assert [o.num_generated for o in engine_cd.generate_batch([(ids, image), (ids, None)])] == [4, 4]
outs = engine_cd.generate_batch_groups([(prompts[0][:p], [ids_[p:] for ids_ in prompts], image)] * 2)
assert [o.num_generated for o in outs] == [4] * 4, outs

# a tiny checkpoint, written here in the safetensors format by hand, loaded
# with the port's own reader (the safetensors package is blocked)
import dataclasses, struct, torch
from llava_align_tpu_torch.config import ClipVisionConfig
from llava_align_tpu_torch.runners.common import load_model as load
from llava_align_tpu_torch.utils import hf_convert
tree = load("random:tiny", device="cpu").params
hf = {"model.embed_tokens.weight": tree["llama"]["embed"], "model.norm.weight": tree["llama"]["final_norm"],
      "lm_head.weight": tree["llama"]["lm_head"]}
names_l = {"attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm", "q": "self_attn.q_proj",
           "k": "self_attn.k_proj", "v": "self_attn.v_proj", "o": "self_attn.o_proj", "gate": "mlp.gate_proj",
           "up": "mlp.up_proj", "down": "mlp.down_proj"}
for k, n in names_l.items():
    for i, w in enumerate(tree["llama"]["layers"][k]):
        hf[f"model.layers.{i}.{n}.weight"] = w
V = "model.vision_tower.vision_tower.vision_model."
vt = tree["vision"]
D = vt["cls"].shape[0]
hf[V + "embeddings.class_embedding"] = vt["cls"]
hf[V + "embeddings.patch_embedding.weight"] = vt["patch_embed"].t().reshape(D, 3, 14, 14)
hf[V + "embeddings.position_embedding.weight"] = vt["pos_embed"]
for ln, n in (("pre_ln", "pre_layrnorm"), ("post_ln", "post_layernorm")):
    hf[V + n + ".weight"], hf[V + n + ".bias"] = vt[ln]["scale"], vt[ln]["bias"]
names_v = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj", "o": "self_attn.out_proj",
           "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
for i in range(vt["layers"]["q"]["kernel"].shape[0]):
    for k, n in names_v.items():
        hf[V + f"encoder.layers.{i}.{n}.weight"] = vt["layers"][k]["kernel"][i].t()
        hf[V + f"encoder.layers.{i}.{n}.bias"] = vt["layers"][k]["bias"][i]
    for k, n in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
        hf[V + f"encoder.layers.{i}.{n}.weight"] = vt["layers"][k]["scale"][i]
        hf[V + f"encoder.layers.{i}.{n}.bias"] = vt["layers"][k]["bias"][i]
for j, layer in enumerate(tree["projector"]["layers"]):
    hf[f"model.mm_projector.{2 * j}.weight"] = layer["kernel"].t()
    hf[f"model.mm_projector.{2 * j}.bias"] = layer["bias"]
ck = os.path.join(d, "llava-tiny")
os.makedirs(ck)
header, blobs, off = {}, [], 0
for k, t in hf.items():
    b = t.to(torch.bfloat16).contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    header[k] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [off, off + len(b)]}
    blobs.append(b)
    off += len(b)
h = json.dumps(header).encode()
with open(os.path.join(ck, "model.safetensors"), "wb") as f:
    f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))
with open(os.path.join(ck, "config.json"), "w") as f:
    json.dump({"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
               "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 512,
               "mm_projector_type": "mlp2x_gelu"}, f)
hf_convert.ClipVisionConfig = lambda **kw: dataclasses.replace(ClipVisionConfig.tiny(), **kw)
params, cfg = hf_convert.load_llava_checkpoint(ck, torch.float32, device="cpu")
assert torch.equal(params["vision"]["patch_embed"], vt["patch_embed"].to(torch.bfloat16).float())
assert torch.equal(params["llama"]["layers"]["down"], tree["llama"]["layers"]["down"].to(torch.bfloat16).float())
assert DecodeEngine(params, cfg, gen).generate(ids, image).num_generated == 4
try:
    load(ck, device="cpu")
    raise AssertionError("load_model loaded a tokenizer without transformers")
except ImportError as e:
    assert "transformers" in str(e)

# the MME and MMMU runners and scorers
from llava_align_tpu_torch.runners import mme, mmmu
root = os.path.join(d, "MME_Benchmark", "existence")
os.makedirs(root)
mf = os.path.join(d, "mme.jsonl")
with open(mf, "w") as f, open(os.path.join(root, "000.txt"), "w") as g:
    for q, a in (("Is there a dog in this image? Please answer yes or no.", "Yes"),
                 ("Is there a cat in this image? Please answer yes or no.", "No")):
        f.write(json.dumps({"question_id": "existence/000.png", "image": "existence/000.png", "text": q}) + "\n")
        g.write(q + "\t" + a + "\n")
base = ["--model-path", "random:tiny", "--device", "cpu", "--synthetic-images", "--max_new_tokens", "2",
        "--temperature", "0", "--use_dd", "--use_dd_unk"]
with contextlib.redirect_stdout(io.StringIO()):
    rep = mme.main(base + ["--question-file", mf, "--answers-file", os.path.join(d, "mme", "a.jsonl"),
                           "--mme-data-root", os.path.join(d, "MME_Benchmark")])
task = rep["Perception"]["tasks"]["existence"]  # random weights: mostly 'other'
assert sum(task[k] for k in ("TP", "FN", "TN", "FP", "other_num")) == 2, rep
uf = os.path.join(d, "mmmu.jsonl")
with open(uf, "w") as f:
    f.write(json.dumps({"id": "v_1", "question_type": "multiple-choice", "answer": "A", "all_choices": ["A", "B"],
                        "index2ans": {"A": "x", "B": "y"}, "final_input_prompt": "<image 1> Pick (A) x (B) y",
                        "image": "u.png"}) + "\n")
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    assert mmmu.main(base + ["--question-file", uf, "--answers-file", os.path.join(d, "mmmu.jsonl.out"),
                             "--calibrate", "--score-setting", "none_unk", "--print-table"]) == 0
assert "Overall" in printed.getvalue()

# the last decoder families: LLaVA-MPT, BLIP-2 OPT (on precomputed_feats),
# BLIP-2 FlanT5's t5_generate and stage-1 captions, tiny random trees
from llava_align_tpu_torch.decoding.adapters import Blip2OptAdapter, LlavaMptAdapter
from llava_align_tpu_torch.models import blip2, llava_mpt
mcfg = llava_mpt.LlavaMptConfig.tiny()
meng = DecodeEngine(llava_mpt.init(mcfg, device="cpu"), mcfg, gen, adapter=LlavaMptAdapter(mcfg))
assert meng.generate(ids, image).num_generated == 4
ocfg = blip2.Blip2OptConfig.tiny()
op = blip2.init_opt(ocfg, device="cpu")
pix = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 3, 28, 28)).astype(np.float32))
feats = blip2.encode_image_queries(op, ocfg, pix)
gen_opt = GenerationConfig(max_new_tokens=4, do_sample=False, use_dd=True, eos_token_id=10**9)
oeng = DecodeEngine(op, ocfg, gen_opt, adapter=Blip2OptAdapter(ocfg))
assert oeng.generate([-200, 1, 5, 6], precomputed_feats=feats).num_generated == 4
tcfg = blip2.Blip2T5Config.tiny()
caps = blip2.t5_generate(blip2.init_t5(tcfg, device="cpu"), tcfg, pix, [[5, 6, 1]], max_new_tokens=3,
                         eos_token_id=10**6)
assert [len(c) for c in caps] == [3], caps
scfg = blip2.Blip2QformerConfig.tiny()
cap = blip2.generate_caption(blip2.init_stage1(scfg, device="cpu"), scfg, pix, bos_token_id=101,
                             eos_token_id=10**6, max_new_tokens=3)
assert cap.shape == (1, 3), cap

loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "llava_align_tpu", "safetensors",
                                                      "transformers"))]
assert not loaded, loaded
print("OK", len(names), out.token_ids)
"""


TWINS_CODE = r"""
import sys
for blocked in ("jax", "jaxlib", "llava_align_tpu", "scripts"):
    sys.modules[blocked] = None  # any import of them now raises ImportError

import importlib
import llava_align_tpu_torch.ops.stream_probes
from llava_align_tpu_torch.scripts import TWINS

for name in TWINS:
    mod = importlib.import_module("llava_align_tpu_torch.scripts." + name)
    assert mod.main(["--device", "cpu", "--tiny"]), name
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "llava_align_tpu", "scripts"))]
assert not loaded, loaded
print("OK", TWINS)
"""


QWEN_CODE = r"""
import sys
for blocked in ("jax", "jaxlib", "llava_align_tpu", "safetensors", "transformers", "regex"):
    sys.modules[blocked] = None  # any import of them now raises ImportError

import contextlib, io, json, os, tempfile
from llava_align_tpu_torch.evals.pope import load_jsonl, main as score_main
from llava_align_tpu_torch.models import qwen_generation_utils, qwen_tokenizer  # import without regex
from llava_align_tpu_torch.runners import mme, mmmu, qwen_pope

d = tempfile.mkdtemp()
qf = os.path.join(d, "q_POPE.jsonl")
with open(qf, "w") as f:
    for i in range(4):
        f.write(json.dumps({"question_id": i, "image": f"img_{i // 2}.jpg", "label": ["yes", "no"][i % 2],
                            "text": f"Is there a {['dog', 'cat'][i % 2]} in the image?"}) + "\n")
base = ["--model-path", "random:tiny", "--device", "cpu", "--synthetic-images", "--max_new_tokens", "3",
        "--temperature", "0", "--use_dd", "--use_dd_unk"]
for layout in (["--group-by-image"], ["--no-group-by-image", "--batch-size", "2"]):
    af = os.path.join(d, f"qwen_{len(layout)}.jsonl")
    qwen_pope.run(qwen_pope.build_parser().parse_args(
        base + ["--question-file", qf, "--answers-file", af, "--quant", "int8", "--calibrate"] + layout))
    recs = load_jsonl(af)
    assert [r["question_id"] for r in recs] == [0, 1, 2, 3] and all("none" in r and "unk" in r for r in recs)
    with contextlib.redirect_stdout(io.StringIO()):
        assert score_main([qf, af]) == 0
try:
    qwen_pope.run(qwen_pope.build_parser().parse_args(
        base + ["--question-file", qf, "--answers-file", af, "--quant", "int4"]))
    raise AssertionError("qwen int4 was not refused")
except ValueError as e:
    assert "qwen int4 is unsupported" in str(e)
try:
    qwen_tokenizer.QwenTokenizer(mergeable_ranks={bytes([i]): i for i in range(256)})
    raise AssertionError("the tokenizer built without regex")
except ImportError as e:
    assert "regex" in str(e)

root = os.path.join(d, "MME_Benchmark", "existence")
os.makedirs(root)
mf = os.path.join(d, "mme.jsonl")
with open(mf, "w") as f, open(os.path.join(root, "000.txt"), "w") as g:
    for q, a in (("Is there a dog in this image? Please answer yes or no.", "Yes"),
                 ("Is there a cat in this image? Please answer yes or no.", "No")):
        f.write(json.dumps({"question_id": "existence/000.png", "image": "existence/000.png", "text": q}) + "\n")
        g.write(q + "\t" + a + "\n")
with contextlib.redirect_stdout(io.StringIO()):
    rep = mme.main(base + ["--model-family", "qwen", "--question-file", mf, "--answers-file",
                           os.path.join(d, "mme", "a.jsonl"), "--mme-data-root", os.path.join(d, "MME_Benchmark")])
task = rep["Perception"]["tasks"]["existence"]
assert sum(task[k] for k in ("TP", "FN", "TN", "FP", "other_num")) == 2, rep
uf = os.path.join(d, "mmmu.jsonl")
with open(uf, "w") as f:
    f.write(json.dumps({"id": "v_1", "question_type": "multiple-choice", "answer": "A", "all_choices": ["A", "B"],
                        "index2ans": {"A": "x", "B": "y"}, "final_input_prompt": "<image 1> Pick (A) x (B) y",
                        "image": "u.png"}) + "\n")
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    assert mmmu.main(base + ["--model-family", "qwen", "--quant", "int8", "--question-file", uf,
                             "--answers-file", os.path.join(d, "mmmu.out.jsonl"), "--calibrate",
                             "--score-setting", "none_unk", "--print-table"]) == 0
assert "Overall" in printed.getvalue()

loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "llava_align_tpu", "safetensors",
                                                      "transformers", "regex"))]
assert not loaded, loaded
print("OK")
"""


BLIP_CODE = r"""
import sys
for blocked in ("jax", "jaxlib", "llava_align_tpu", "safetensors", "transformers", "PIL"):
    sys.modules[blocked] = None  # any import of them now raises ImportError

import contextlib, io, json, os, tempfile
from llava_align_tpu_torch.evals.pope import load_jsonl, main as score_main
from llava_align_tpu_torch.runners import blip_pope, caption

d = tempfile.mkdtemp()
qf = os.path.join(d, "q_POPE.jsonl")
with open(qf, "w") as f:
    for i in range(4):
        f.write(json.dumps({"question_id": i, "image": f"img_{i // 2}.jpg", "label": ["yes", "no"][i % 2],
                            "text": f"Is there a {['dog', 'cat'][i % 2]} in the image?"}) + "\n")
base = ["--model-path", "random:tiny", "--device", "cpu", "--synthetic-images", "--max_new_tokens", "3",
        "--temperature", "0", "--question-file", qf, "--calibrate"]
for flags in ([], ["--use_cd", "--noise_step", "500"]):
    af = os.path.join(d, f"blip_{len(flags)}.jsonl")
    blip_pope.run(blip_pope.build_parser().parse_args(base + ["--answers-file", af] + flags))
    recs = load_jsonl(af)
    assert [r["question_id"] for r in recs] == [0, 1, 2, 3] and all("none" in r and "noise" in r for r in recs)
    with contextlib.redirect_stdout(io.StringIO()):
        assert score_main([qf, af]) == 0
rd = os.path.join(d, "captions")
with contextlib.redirect_stdout(io.StringIO()):
    caption.run(caption.build_parser().parse_args(
        ["--model-path", "random:tiny", "--device", "cpu", "--synthetic-images", "--question-file", qf,
         "--result-dir", rd, "--num-beams", "3", "--max-len", "6", "--min-len", "2"]))
caps = json.load(open(os.path.join(rd, "val_epoch0.json")))
assert [c["image_id"] for c in caps] == [0, 1, 2, 3] and all(c["caption"] for c in caps), caps

loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "llava_align_tpu", "safetensors",
                                                      "transformers", "PIL"))]
assert not loaded, loaded
print("OK")
"""


QUANT_CODE = r"""
import sys
for blocked in ("jax", "jaxlib", "llava_align_tpu", "safetensors", "transformers", "openai"):
    sys.modules[blocked] = None  # any import of them now raises ImportError

import json, os, tempfile
import numpy as np
from llava_align_tpu_torch.config import GenerationConfig
from llava_align_tpu_torch.decoding.adapters import InstructBlipAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine
from llava_align_tpu_torch.evals import gpt_review
from llava_align_tpu_torch.evals.pope import load_jsonl
from llava_align_tpu_torch.models import instructblip
from llava_align_tpu_torch.models.instructblip import InstructBlipConfig
from llava_align_tpu_torch.ops import quant
from llava_align_tpu_torch.runners import bias_probe, pope, qwen_pope, sampling
from llava_align_tpu_torch.runners.common import load_model

d = tempfile.mkdtemp()
qf = os.path.join(d, "q_POPE.jsonl")
with open(qf, "w") as f:
    for i in range(6):
        f.write(json.dumps({"question_id": i, "image": f"img_{i // 3}.jpg", "label": ["yes", "no"][i % 2],
                            "text": f"Is there a {['dog', 'cat'][i % 2]} in the image?"}) + "\n")
base = ["--model-path", "random:tiny", "--device", "cpu", "--synthetic-images", "--max_new_tokens", "3",
        "--question-file", qf]
# --quant w8a8: 6 questions x a 128-bucket prompt = 768 rows, so W8A8 takes the prefills
n0 = quant.int8_matmul_w8a8.launches
af = os.path.join(d, "w8a8.jsonl")
pope.run(pope.build_parser().parse_args(base + ["--answers-file", af, "--quant", "w8a8", "--use_dd", "--use_dd_unk",
                                                "--temperature", "0", "--no-group-by-image", "--batch-size", "6"]))
assert len(load_jsonl(af)) == 6 and quant.int8_matmul_w8a8.launches > n0
qwen_pope.run(qwen_pope.build_parser().parse_args(
    base + ["--answers-file", os.path.join(d, "qwen_w8a8.jsonl"), "--quant", "w8a8", "--temperature", "0"]))
# the int8 KV cache through generate, the lockstep batch, the grouped path and beams
lm = load_model("random:tiny", device="cpu")
lm.params["llama"] = quant.quantize_llama_params(lm.params["llama"])
gen = GenerationConfig(max_new_tokens=3, do_sample=False, use_dd=True, use_dd_unk=True, eos_token_id=10**9)
eng = DecodeEngine(lm.params, lm.cfg, gen, kv_quant="int8", act_quant=True)
ids = [1, 5, -200, 6, 7]
image = np.random.default_rng(0).integers(0, 256, (3, 28, 28), dtype=np.uint8)
assert eng.generate(ids, image).num_generated == 3
assert [o.num_generated for o in eng.generate_batch([(ids, image), (ids, None)])] == [3, 3]
assert [o.num_generated for o in eng.generate_batch_groups([(ids[:3], [[6, 7], [8]], image)] * 2)] == [3] * 4
bcfg = InstructBlipConfig.tiny()
bp = instructblip.init(bcfg, device="cpu")
beng = DecodeEngine(bp, bcfg, GenerationConfig(max_new_tokens=4, do_sample=False, eos_token_id=10**9),
                    adapter=InstructBlipAdapter(bcfg), kv_quant="int8")
feats = np.zeros((1, 1, bcfg.text.hidden_size), np.float32)
assert beng.generate_beam([1, 5, 6], precomputed_feats=feats, num_beams=3).num_generated == 4
# the sweep (smoke grid), the bias probe and the judge pipeline
files = sampling.run_sweep(sampling.build_parser().parse_args(
    base + ["--answers-file", os.path.join(d, "sw_setting.jsonl"), "--grid", "smoke", "--use_dd"]))
assert [os.path.basename(f) for f in files] == ["sw_default.jsonl", "sw_temp_0.5.jsonl", "sw_top_p_0.5.jsonl",
                                                "sw_top_k_5.jsonl"]
pf = bias_probe.run(bias_probe.build_parser().parse_args(base + ["--answers-file", os.path.join(d, "probe.jsonl")]))
assert all({"none", "unk", "zero", "one", "noise", "naive"} <= set(r) for r in load_jsonl(pf))
q = [{"question_id": 0, "image": "i.jpg", "text": "q", "category": "conv"}]
res = gpt_review.run_review(q, [{"question_id": 0, "text": "a"}], [{"question_id": 0, "text": "b"}],
                            [{"image": "i.jpg", "captions": ["c"], "instances": []}],
                            {"conv": {"role": "Assistant", "prompt": "rate"}}, lambda c, n: "7 8\nok",
                            os.path.join(d, "review.jsonl"))
assert gpt_review.summarize_reviews(res)["all"]["score_2"] == 8.0
try:
    gpt_review.openai_judge()
    raise AssertionError("openai_judge built without the openai package")
except ImportError:
    pass

loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m.split(".")[0] in ("jax", "jaxlib", "llava_align_tpu", "safetensors",
                                                      "transformers", "openai"))]
assert not loaded, loaded
print("OK")
"""


TRAIN_CODE = r"""
import sys
for blocked in ("jax", "jaxlib", "llava_align_tpu", "safetensors", "transformers"):
    sys.modules[blocked] = None

import json, os, tempfile
import yaml
import torch
from llava_align_tpu_torch.runners import train

d = tempfile.mkdtemp()
ann = os.path.join(d, "ann.json")
with open(ann, "w") as f:
    json.dump([{"image": f"img_{i % 2}.jpg", "caption": c, "image_id": i % 2}
               for i, c in enumerate(["a dog", "two cats on a mat", "a red car", "a bowl of fruit"])], f)
cfg = {"model": {"arch": "llava", "size": "tiny"},
       "datasets": {"coco_caption": {"build_info": {"train": {"ann_paths": [ann], "vis_root": d}},
                                     "synthetic_images": True}},
       "run": {"task": "captioning", "batch_size_train": 2, "max_epoch": 2, "init_lr": 1e-3,
               "warmup_steps": 1, "output_dir": os.path.join(d, "out"), "log_freq": 100}}
path = os.path.join(d, "train.yaml")
with open(path, "w") as f:
    yaml.safe_dump(cfg, f)
stats = train.main(["--cfg-path", path, "--options", "run.device=cpu"])
assert stats["loss"] == stats["loss"] and stats["loss"] > 0, stats
state = torch.load(os.path.join(d, "out", "checkpoint_last", "state.pt"), weights_only=True)
assert state["epoch"] == 1 and state["opt_state"]["count"] == 4, state.keys()
stats = train.main(["--cfg-path", path, "--options", "run.device=cpu", "run.max_epoch=3",
                    "run.resume_ckpt_path=" + os.path.join(d, "out", "checkpoint_last")])
state = torch.load(os.path.join(d, "out", "checkpoint_last", "state.pt"), weights_only=True)
assert state["epoch"] == 2 and state["opt_state"]["count"] == 6

# the LAVIS archs' train steps build on their zoo entries (their epochs are
# held to the JAX CLI's in tests/test_torch_lavis_train_cli*.py)
from llava_align_tpu_torch.framework.model_zoo import load_model
from llava_align_tpu_torch.framework.optims import build_optimizer
for arch in ("albef_retrieval", "albef_classification", "blip_classification", "clip"):
    model = load_model(arch, device="cpu", num_classes=2)
    tx = build_optimizer(init_lr=1e-3, max_steps=1, steps_per_epoch=1)
    step, init_state, prep = train._make_train_step(arch, model, tx, device="cpu")
    assert init_state(model.params) is not None, arch

# every LAVIS arch of the zoo builds (tiny, random) with its processors
from llava_align_tpu_torch.framework.model_zoo import load_model_and_preprocess
for arch in ("blip_caption", "blip_retrieval", "blip_nlvr", "albef_vqa", "albef_nlvr", "clip_feature_extractor",
             "blip2", "blip2_opt", "blip2_t5_instruct"):
    model, vis, txt = load_model_and_preprocess(arch, device="cpu")
    assert model.arch == arch and set(vis) == {"train", "eval"}, arch

loaded = [m for m, mod in sys.modules.items()
          if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "llava_align_tpu", "safetensors",
                                                     "transformers")]
assert not loaded, loaded
print("OK")
"""


PARALLEL_CODE = r"""
import sys
for blocked in ("jax", "jaxlib", "llava_align_tpu", "safetensors", "transformers"):
    sys.modules[blocked] = None
from llava_align_tpu_torch.parallel import comm, dist, dryrun, mesh, sharding  # noqa: F401
r = dryrun.dryrun_multichip(2, device="cpu", timeout=240)
assert r["model"] == 2 and r["data"] == 1, r
print("OK")
"""


UTIL_CODE = r"""
import sys
for blocked in ("jax", "jaxlib", "llava_align_tpu", "safetensors", "transformers", "regex", "openai"):
    sys.modules[blocked] = None

import json, os, tempfile
import torch
from llava_align_tpu_torch.framework.data import JsonlDataset
from llava_align_tpu_torch.framework.registry import registry
from llava_align_tpu_torch.framework.tasks import PopeTask
from llava_align_tpu_torch.utils import checkpoint_tools, moderation, parity_check, profiling  # noqa: F401

d = tempfile.mkdtemp()
path = os.path.join(d, "q.jsonl")
rows = [{"question_id": i, "text": f"Is there a dog #{i}?", "label": "yes" if i % 2 else "no"} for i in range(6)]
with open(path, "w") as f:
    f.write("".join(json.dumps(r) + "\n" for r in rows))
ds = JsonlDataset(path)
assert ds.native and [ds[i] for i in range(len(ds))] == rows  # g++ builds the loader into build/native/
assert registry.get_task_class("pope") is PopeTask
task = PopeTask(generate_fn=lambda params, s: "Yes" if s["label"] == "yes" else "No")
metrics = task.after_evaluation(task.evaluation(None, [ds[i] for i in range(len(ds))], log_freq=100))
assert metrics["accuracy"] == 1.0 and metrics["agg_metrics"] == metrics["f1"] == 1.0
timer = profiling.PhaseTimer()
with timer.phase("x"), profiling.trace(os.path.join(d, "trace")):
    torch.ones(3) * 2
assert timer.report()["x"]["count"] == 1 and os.path.exists(os.path.join(d, "trace", profiling.TRACE_FILE))
delta = checkpoint_tools.make_delta({"w": torch.ones(2)}, {"w": torch.full((2,), 3.0)})
assert (delta["w"] == 2).all()
assert moderation.violates_moderation("text") is False  # no openai: fails open, as in JAX

loaded = [m for m, mod in sys.modules.items()
          if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "llava_align_tpu", "safetensors",
                                                     "transformers", "regex", "openai")]
assert not loaded, loaded
print("OK")
"""


# every subprocess of this module: name -> (code, the packages blocked by
# stub packages on PYTHONPATH, which spawned children see too)
RUNS = {
    "port": (CODE, ()),
    "twins": (TWINS_CODE, ()),
    "qwen": (QWEN_CODE, ()),
    "blip": (BLIP_CODE, ()),
    "quant": (QUANT_CODE, ()),
    "train": (TRAIN_CODE, ()),
    "parallel": (PARALLEL_CODE, ("jax", "jaxlib", "llava_align_tpu", "safetensors", "transformers")),
    "util": (UTIL_CODE, ()),
}


RUNS_AT_ONCE = 4  # beside the suite's other workers: all eight at once would crowd their cores


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of RUNS, RUNS_AT_ONCE at a time from the module's
    first test on (each on one intra-op thread: beside the suite's parallel
    workers, a child with a thread per core spins at every parallel
    region; the twins' host-clock loops ran 9 s alone on one thread, 156 s
    on eight beside three busy processes), 300 s at most each: name -> the
    Future of its CompletedProcess."""
    from concurrent.futures import ThreadPoolExecutor

    root = tmp_path_factory.mktemp("no_jax")

    def run(name, code, blocked):
        pythonpath = REPO
        if blocked:
            stubs = root / f"{name}_stubs"
            for pkg in blocked:
                (stubs / pkg).mkdir(parents=True)
                (stubs / pkg / "__init__.py").write_text(f"raise ImportError('{pkg} is blocked')\n")
            pythonpath = f"{stubs}{os.pathsep}{REPO}"
        env = dict(os.environ, PYTHONPATH=pythonpath, OMP_NUM_THREADS="1")
        return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=300)

    with ThreadPoolExecutor(RUNS_AT_ONCE) as pool:
        yield {name: pool.submit(run, name, code, blocked) for name, (code, blocked) in RUNS.items()}


def _result(runs, name: str) -> subprocess.CompletedProcess:
    return runs[name].result()


def test_parallel_runs_with_jax_blocked(runs):
    """parallel/* imports, and the dry run (a TP train step, the sharded
    engine token-exact against one device, int8 TP with padding, W8A8
    under TP) runs on 2 spawned gloo ranks, with jax, the JAX package,
    safetensors and transformers unimportable in the parent and in the
    ranks (stub packages that raise, first on the ranks' PYTHONPATH)."""
    proc = _result(runs, "parallel")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "OK", proc.stdout[-2000:]


def test_port_runs_with_jax_blocked(runs):
    proc = _result(runs, "port")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK"), proc.stdout


def test_microbenchmark_twins_run_with_jax_blocked(runs):
    """Each twin of a TPU script imports and runs its main() at rehearsal
    size, with neither jax, the JAX package nor scripts/ importable."""
    proc = _result(runs, "twins")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1].startswith("OK"), proc.stdout[-2000:]


def test_qwen_slice_runs_with_jax_and_regex_blocked(runs):
    """The Qwen-VL runners on random:tiny with jax, the JAX package,
    safetensors, transformers and regex all unimportable."""
    proc = _result(runs, "qwen")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "OK", proc.stdout[-2000:]


def test_blip_slice_runs_with_jax_and_pil_blocked(runs):
    """The InstructBLIP POPE runner (plain and VCD, --calibrate, scored) and
    the caption runner on random:tiny with jax, the JAX package,
    safetensors, transformers and PIL all unimportable (synthetic images
    need no PIL)."""
    proc = _result(runs, "blip")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "OK", proc.stdout[-2000:]


def test_quant_modes_and_last_runners_run_with_jax_blocked(runs):
    """--quant w8a8 through the POPE and Qwen runners, the int8 KV cache
    (with W8A8) through every engine entry point and beams, the sampling
    sweep's smoke grid, the bias probe and the judge pipeline (an injected
    judge; openai_judge needs the openai package) on random:tiny with jax,
    the JAX package, safetensors, transformers and openai unimportable."""
    proc = _result(runs, "quant")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "OK", proc.stdout[-2000:]


def test_train_cli_runs_with_jax_blocked(runs):
    """runners/train.main on a captioning YAML (model arch llava, size
    tiny, synthetic images), 2 epochs then a resume from checkpoint_last;
    then the train step of each LAVIS arch (albef_retrieval,
    albef_classification, blip_classification, clip) built on its zoo
    entry, and the LAVIS zoo's entries built with their processors, with jax, the JAX package, safetensors and transformers
    unimportable (the card machine has PyYAML and Pillow, which this path
    reads)."""
    proc = _result(runs, "train")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "OK", proc.stdout[-2000:]


def test_utility_tail_runs_with_jax_and_regex_blocked(runs):
    """The native loader (JsonlDataset on its native path), PopeTask
    through its evaluation, PhaseTimer and trace, the checkpoint tools and
    moderation, with jax, the JAX package, safetensors, transformers, regex
    and openai unimportable (parity_check imports without transformers:
    only its oracle and CLI read it)."""
    proc = _result(runs, "util")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "OK", proc.stdout[-2000:]
