"""The port's parallelism (llava_align_tpu_torch/parallel, the TP paths of
ops/quant, models/llama, clip_vit, llava, the engine's mesh= and the
trainer's) against the JAX package's, on the CPU.

In process:
- the spec trees of parallel/sharding against JAX's llava_param_shardings
  / complete_shardings and the adapters' param_shardings (float tree and an
  int8-fused TP-ready tree), compared as (dim, axis) pairs, and the cache's;
- int8_tp_aligned and the padded stacks of pad_llama_quantized_for_tp
  against JAX's, exactly;
- shard_params' slices (fused blocks too) concatenating back to the leaf.

One spawn of 4 gloo ranks (data = 2, model = 2, one thread each) on a
tiny LLaVA drawn from a seed (numpy), carried over by from_jax_params:
- int8_matmul_stacked_tp, column and row, plain and W8A8, against JAX's on
  a 2-device CPU mesh: fp32 within 1e-5 of the largest output, W8A8 bit
  for bit;
- greedy tokens of generate (dual VDD, and VCD with one numpy eps injected
  into both engines), generate_batch, generate_batch_prefix and
  generate_beam exactly equal to the JAX engine's, unsharded; VCD
  generate_batch (one numpy eps for the whole batch injected into both:
  the port's split path draws it whole and slices it over 'data') and the
  int8 KV cache in generate_batch_groups too; the int8 intermediate =
  160 * model tree, which must lane-pad, too; and a tree with one kv head,
  which does not split over model = 2 (k/v and the cache stay whole on
  each rank), through generate and generate_batch_groups, with its train
  step against the port's unsharded one;
- sampled decodes under the 'data' split (VCD generate_batch, whose noise
  and draws share one stream, and generate_batch_prefix, whose one group
  leaves a slice empty) equal to the port's unsharded engine's, seed for
  seed;
- one train step: loss within 1e-6 and params within 1e-5 of JAX's
  unsharded step (Adam's noise elements within 2 lr, as
  tests/test_torch_train.py holds them), and AdamW's global norm over the
  sharded tree equal to the unsharded one.

The other four adapters (Qwen-VL, fp32 and int8; LLaVA-MPT; InstructBLIP;
BLIP-2 OPT), in the same spawn: their trees drawn from a seed by the
port's random-tree functions, vocabularies that do not divide the 'model' axis (97;
Qwen's 510 at model 4), greedy tokens under data 2 x model 2 and data 1 x
model 4 exactly equal to the unsharded JAX engine's in each entry point
the adapter takes (InstructBLIP and BLIP-2 OPT encode no image in the
engine: their generate reads precomputed query features, their
generate_batch is text-only and held against JAX's generate question by
question, and neither takes generate_batch_groups, in either package);
and their spec trees against JAX's qwen/mpt/opt_param_shardings leaf for
leaf.

The ranks run while the parent computes the JAX side (the four other
families' references in a process of their own); the parent then holds
the ranks' arrays against JAX's.

One spawn of 2 ranks: the POPE runner with --dist auto on random:tiny,
--device cpu, whose merged answers equal a one-rank run's (one question
a call, so each question's numbers do not depend on the split), made
while the ranks run.

The ranks import this module without JAX (JAX is imported inside the
fixtures and tests only).
"""

import json
import os

import numpy as np
import pytest
import torch

from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX as S
from llava_align_tpu_torch.parallel.dryrun import start

RANK_TIMEOUT = 300.0
EOS = 2
LR = 1e-4
IDS = [1, 5, S, 7, 8, 9]
PROMPTS = ([1, 17, 23, S, 31, 37, 41], [1, 19, S, 29, 31], [1, 5, S, 7, 9, 11, 13, 15, 17])
PREFIX = [1, 5, S, 6]
SUFFIXES = [[7, 8, 9], [7, 11, 13], [17, 19]]
GROUP_SUFFIXES = ([[41, 43, 53], [41, 47, 53, 59], [61, 67]], [[103, 107], [109, 113, 127], [131]])
NOISE_STEP = 500


# ---------------------------------------------------------------------------
# trees and configs (numpy, from seeds)
# ---------------------------------------------------------------------------


def _cfgs(int8_tp: bool = False, kv_heads: int = 2):
    """(JAX config, port config): LlavaConfig.tiny (heads 4, kv 2, vision
    heads 2: every split dim divides by 2; kv_heads=1: one kv head, which
    does not split), or the JAX dryrun's int8 profile, whose intermediate
    160 * 2 is not lane-aligned per shard."""
    import dataclasses

    from llava_align_tpu.config import LlamaConfig as JL
    from llava_align_tpu.config import LlavaConfig as JC

    from llava_align_tpu_torch.config import LlamaConfig as TL
    from llava_align_tpu_torch.config import LlavaConfig as TC

    if not int8_tp:
        jc, tc = JC.tiny(vocab_size=64), TC.tiny(vocab_size=64)
        return (dataclasses.replace(jc, text=dataclasses.replace(jc.text, num_kv_heads=kv_heads)),
                dataclasses.replace(tc, text=dataclasses.replace(tc.text, num_kv_heads=kv_heads)))
    import jax.numpy as jnp

    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=160 * 2, num_layers=2, num_heads=2,
              num_kv_heads=2, head_dim=128)
    jc, tc = JC.tiny(), TC.tiny()
    return (JC(text=JL(**kw, dtype=jnp.float32), vision=jc.vision),
            TC(text=TL(**kw, dtype=torch.float32), vision=tc.vision))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def _tree(tcfg, seed):
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    return _numpy_tree(build_random_llava_params(tcfg, device="cpu", seed=seed))


def _images(n=3):
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, (3, 28, 28), dtype=np.uint8) for _ in range(n)]


def _eps(n=1, seed=5):
    return np.random.default_rng(seed).standard_normal((n, 3, 28, 28)).astype(np.float32)


def _gen(cls, max_new=4, do_sample=False, **kw):
    return cls(max_new_tokens=max_new, do_sample=do_sample, eos_token_id=EOS, cd_alpha=1.0, cd_beta=0.1,
               noise_step=NOISE_STEP, **kw)


DUAL = dict(use_dd=True, use_dd_unk=True)
VCD = dict(use_cd=True)


class _StubMesh:
    """The two things parallel/mesh reads from a DeviceMesh, for one rank
    of an in-process test."""

    def __init__(self, data, model, rank):
        self.shape = (data, model)
        self._coord = {"data": rank // model, "model": rank % model}

    def get_local_rank(self, axis):
        return self._coord[axis]


# ---------------------------------------------------------------------------
# in process: the pure functions
# ---------------------------------------------------------------------------


def _jax_pairs(sharding):
    return tuple((i, ax) for i, ax in enumerate(sharding.spec) if ax is not None)


def _assert_specs_equal(port_specs, jax_specs, params):
    import jax

    from llava_align_tpu_torch.parallel.sharding import spec_leaves, spec_pairs

    want = jax.tree_util.tree_leaves_with_path(jax_specs)
    got = [spec_pairs(s) for s in spec_leaves(port_specs)]
    assert len(want) == len(got) == len(jax.tree_util.tree_leaves(params))
    for (path, w), g in zip(want, got):
        assert _jax_pairs(w) == g, (jax.tree_util.keystr(path), _jax_pairs(w), g)


def test_sharding_specs_match_jax():
    import jax
    from llava_align_tpu.decoding.adapters import LlavaAdapter as JAdapter
    from llava_align_tpu.ops.quant import quantize_llama_params as jquantize
    from llava_align_tpu.parallel import sharding as jshd
    from llava_align_tpu.parallel.mesh import make_mesh as jmesh

    from llava_align_tpu_torch.decoding.adapters import LlavaAdapter as TAdapter
    from llava_align_tpu_torch.parallel import sharding as tshd
    from llava_align_tpu_torch.utils.jax_params import from_jax_params

    mesh = jmesh(model=2, data=1, devices=jax.devices()[:2])
    stub = _StubMesh(1, 2, 0)
    for int8 in (False, True):
        jcfg, tcfg = _cfgs(int8_tp=int8)
        tree = _tree(tcfg, 0)
        if int8:  # fused int8 stacks, TP-ready once padded (the engine's order)
            tree = dict(tree, llama=jax.device_get(jquantize(tree["llama"], fuse=True)))
            jtree = JAdapter(jcfg).int8_tp_pad(tree, 2)
            assert JAdapter(jcfg).int8_tp_ready(jtree, 2)
            want = JAdapter(jcfg).param_shardings(jtree, mesh)
            ttree = from_jax_params(jtree, device="cpu")
            got = TAdapter(tcfg).param_shardings(ttree, stub)
            _assert_specs_equal(got, want, jtree)
        else:
            want = jshd.complete_shardings(tree, jshd.llava_param_shardings(jcfg, mesh, tree), mesh)
            ttree = from_jax_params(tree, device="cpu")
            got = tshd.complete_shardings(ttree, tshd.llava_param_shardings(tcfg, ttree))
            _assert_specs_equal(got, want, tree)
            # the adapter's placement of a float tree is the same
            _assert_specs_equal(TAdapter(tcfg).param_shardings(ttree, stub), want, tree)
    jc = jshd.cache_shardings(mesh)
    tc = tshd.cache_shardings()
    for k in ("k", "v"):
        assert _jax_pairs(jc[k]) == tshd.spec_pairs(tc[k])


def test_int8_tp_alignment_and_padding_match_jax():
    import jax
    import jax.numpy as jnp
    from llava_align_tpu.ops import quant as jq

    from llava_align_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(7)

    def stack(L, O, D):
        return {"q": rng.integers(-127, 128, (L, O, D), dtype=np.int8),
                "s": rng.random((L, O)).astype(np.float32) + 0.01}

    for (O, D) in ((512, 256), (320, 64), (11008 // 8, 128), (256, 384)):
        w = stack(1, O, D)
        tw = {k: torch.from_numpy(v) for k, v in w.items()}
        for mode in ("column", "row"):
            for n in (1, 2, 4):
                assert tq.int8_tp_aligned(tw, mode, n) == jq.int8_tp_aligned(w, mode, n), (O, D, mode, n)
    layers = {"qkv": stack(2, 3 * 128, 64), "o": stack(2, 64, 128), "gateup": stack(2, 2 * 320, 64),
              "down": stack(2, 64, 320), "attn_norm": rng.random((2, 64)).astype(np.float32)}
    for n in (2, 4):
        want, wch = jq.pad_llama_quantized_for_tp(jax.tree_util.tree_map(jnp.asarray, layers), n)
        got, gch = tq.pad_llama_quantized_for_tp(
            {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else torch.from_numpy(v)) for k, v in layers.items()}, n)
        assert wch == gch is True
        for k in layers:
            if isinstance(layers[k], dict):
                for kk in ("q", "s"):
                    np.testing.assert_array_equal(got[k][kk].numpy(), np.asarray(want[k][kk]), err_msg=(k, kk, n))
        assert got["gateup"]["q"].shape[1] == 2 * got["down"]["q"].shape[2]  # both halves and down: one F_pad


def test_shard_params_slices_concatenate_to_the_leaf():
    from llava_align_tpu_torch.parallel.sharding import Shard, shard_params

    rng = np.random.default_rng(3)
    tree = {"col": torch.from_numpy(rng.normal(size=(2, 12, 4))), "row": torch.from_numpy(rng.normal(size=(2, 4, 12))),
            "fused": torch.from_numpy(rng.normal(size=(2, 8 + 4 + 4, 3))), "rep": torch.ones(5),
            "q8": {"q": torch.from_numpy(rng.integers(-5, 5, (2, 12, 4), dtype=np.int8)),
                   "s": torch.from_numpy(rng.random((2, 12)))}}
    specs = {"col": Shard(1), "row": Shard(2), "fused": Shard(1, blocks=(8, 4, 4)), "rep": None,
             "q8": {"q": Shard(1), "s": Shard(1)}}
    for n in (2, 4):
        parts = [shard_params(tree, specs, _StubMesh(1, n, r)) for r in range(n)]
        assert torch.equal(torch.cat([p["col"] for p in parts], 1), tree["col"])
        assert torch.equal(torch.cat([p["row"] for p in parts], 2), tree["row"])
        assert torch.equal(torch.cat([p["q8"]["q"] for p in parts], 1), tree["q8"]["q"])
        assert all(p["col"].is_contiguous() and p["row"].is_contiguous() for p in parts)
        assert all(torch.equal(p["rep"], tree["rep"]) for p in parts)
        # a fused stack: each rank holds [q_r | k_r | v_r]
        blocks = [torch.split(p["fused"], [8 // n, 4 // n, 4 // n], dim=1) for p in parts]
        whole = [torch.cat([b[i] for b in blocks], 1) for i in range(3)]
        assert torch.equal(torch.cat(whole, 1), tree["fused"])


# ---------------------------------------------------------------------------
# one spawn of 4 ranks: the TP matmul, the engine, the train step
# ---------------------------------------------------------------------------


def _tp_matmul_cases():
    """(name, h [B, D], wq [L, O, D], mode, act_quant): K1's decode rows
    and the dequant product at 96 rows (row mode), W8A8 at 256."""
    rng = np.random.default_rng(9)
    L, O, D = 2, 256, 256
    wq = {"q": rng.integers(-127, 128, (L, O, D), dtype=np.int8),
          "s": (rng.random((L, O)) * 0.02 + 1e-3).astype(np.float32)}
    cases = []
    for rows, aq in ((4, False), (96, False), (256, True)):
        h = rng.normal(size=(rows, D)).astype(np.float32)
        for mode in ("column", "row"):
            cases.append((f"{mode}_{rows}{'_w8a8' if aq else ''}", h, wq, mode, aq))
    return cases


def _local_stack(wq, mode, r, n):
    O, D = wq["q"].shape[1:]
    if mode == "column":
        o = O // n
        return {"q": wq["q"][:, r * o : (r + 1) * o], "s": wq["s"][:, r * o : (r + 1) * o]}
    d = D // n
    return {"q": wq["q"][:, :, r * d : (r + 1) * d], "s": wq["s"]}


def _patch_port_noise(injected):
    """The port engine's noise draws return `injected`: add_diffusion_noise's
    (a single request) and draw_noise_eps (a batch split over 'data', drawn
    whole, then sliced)."""
    from llava_align_tpu_torch.decoding import engine as tengine_mod
    from llava_align_tpu_torch.ops import noise as tnoise

    def port_noise(images, noise_step, generator=None, eps=None):
        if eps is None:  # a single request's draw; a split batch passes its slice
            eps = torch.from_numpy(injected)
        return tnoise.add_diffusion_noise(images, noise_step, eps=eps)

    def port_eps(shape, generator, device):
        assert tuple(shape) == injected.shape, (shape, injected.shape)
        return torch.from_numpy(injected).to(device)

    saved = tengine_mod.add_diffusion_noise, tengine_mod.draw_noise_eps
    tengine_mod.add_diffusion_noise, tengine_mod.draw_noise_eps = port_noise, port_eps

    def restore():
        tengine_mod.add_diffusion_noise, tengine_mod.draw_noise_eps = saved

    return restore


# ---------------------------------------------------------------------------
# the other four adapters: configs, trees, requests and entry points (the
# same code drives the JAX engine in the parent and the port's on the ranks)
# ---------------------------------------------------------------------------

FAMILIES = ("qwen", "qwen_int8", "mpt", "blip", "opt")
FAMILY_MESHES = ("data2_model2", "data1_model4")
FAMILY_VOCAB = {"qwen": 510, "mpt": 97, "blip": 97, "opt": 97}  # 510 splits 2 ways, not 4; 97 neither


def _family_cfgs(kind: str, jax_side: bool = False):
    """(tiny config of one package, the adapter's class name). qwen_int8: 4
    heads of 128 and a 256-wide MLP half, so that every int8 stack is
    lane-aligned at model 2 and w12 / mlp_proj pad at model 4."""
    import dataclasses
    import importlib

    pkg = "llava_align_tpu" if jax_side else "llava_align_tpu_torch"
    name = {"qwen": "qwen_vl", "mpt": "llava_mpt", "blip": "instructblip", "opt": "blip2"}[kind.split("_")[0]]
    mod = importlib.import_module(f"{pkg}.models.{name}")
    vocab = FAMILY_VOCAB[kind.split("_")[0]]
    if kind.startswith("qwen"):
        cfg = mod.QwenVLConfig.tiny(vocab_size=vocab)
        if kind == "qwen_int8":
            cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_heads=4, head_dim=128,
                                                                    intermediate_size=512))
        return cfg, "QwenVLAdapter"
    if kind == "mpt":
        return mod.LlavaMptConfig.tiny(vocab_size=vocab), "LlavaMptAdapter"
    if kind == "blip":
        return mod.InstructBlipConfig.tiny(vocab_size=vocab), "InstructBlipAdapter"
    return mod.Blip2OptConfig.tiny(vocab_size=vocab), "Blip2OptAdapter"


def _family_tree(kind: str, cfg, seed: int = 0):
    """The port's random tree (numpy leaves) at the port config `cfg`."""
    from llava_align_tpu_torch.models import blip2, instructblip
    from llava_align_tpu_torch.utils import synthetic

    if kind.startswith("qwen"):
        quant = "int8" if kind == "qwen_int8" else "none"
        return _numpy_tree(synthetic.build_random_qwen_vl_params(cfg, quant=quant, device="cpu", seed=seed))
    if kind == "mpt":
        return _numpy_tree(synthetic.build_random_llava_mpt_params(cfg, device="cpu", seed=seed))
    if kind == "blip":
        return _numpy_tree(instructblip.init(cfg, device="cpu", seed=seed))
    return _numpy_tree(blip2.init_opt(cfg, device="cpu", seed=seed))


def _family_requests(kind: str, cfg) -> dict:
    """numpy inputs from a seed: Qwen's three image prompts sharing their
    text but the last tokens, with 'unk' ids, and two images; MPT's LLaVA
    prompts, two images and VCD's eps; InstructBLIP's and OPT's query
    features ([main, noised] rows) and text-only prompts."""
    rng = np.random.default_rng(21)
    if kind.startswith("qwen"):
        from llava_align_tpu_torch.models import qwen_vl

        span, _ = qwen_vl.sentinelize_span(qwen_vl.make_image_span_ids(cfg), cfg)
        common = [int(t) for t in rng.integers(3, 400, 6)]
        tails = [[int(t) for t in rng.integers(3, 400, n)] for n in (3, 2, 3)]
        unk = [int(t) for t in rng.integers(3, 400, 2)]
        H = cfg.vision.image_size
        return dict(ids=[span + common + t for t in tails], unk=[unk + common + t for t in tails],
                    text=common + tails[2], images=[rng.normal(size=(3, H, H)).astype(np.float32) for _ in range(2)])
    if kind == "mpt":
        return dict(ids=list(PROMPTS[:2]), text=[1, 5, 7, 9, 11], images=_images(2), eps=_eps(seed=8))
    H = cfg.text.hidden_size
    return dict(ids=[S, 1, 40, 50, 60], feats=rng.normal(size=(2, cfg.num_query_tokens, H)).astype(np.float32),
                text=[[1, 17, 23, 31], [1, 19, 29, 31, 37, 41, 43]])


def _family_tokens(kind: str, make, req: dict, jax_side: bool = False) -> dict:
    """Greedy tokens of each entry point the family's adapter takes, on the
    engines `make(flags)` builds (either package's)."""
    def toks(outs):
        return [o.token_ids for o in outs]

    out = {}
    ids, images = req["ids"], req.get("images")
    if kind.startswith("qwen"):
        dual = make(DUAL)
        out["generate"] = dual.generate(ids[0], images[0], branch_ids={"unk": req["unk"][0]}).token_ids
        if kind == "qwen_int8":
            return out
        out["generate_batch"] = toks(make({"use_dd": True}).generate_batch(
            [(ids[0], images[0]), (ids[1], images[1]), (req["text"], None)]))
        p = min(len(a) for a in ids)
        p = next((i for i in range(p) if len({a[i] for a in ids}) > 1), p)
        groups = [(ids[0][:p], [a[p:] for a in ids[g:g + 2]], images[g], [{"unk": u} for u in req["unk"][g:g + 2]])
                  for g in range(2)]
        out["generate_batch_groups"] = toks(dual.generate_batch_groups(groups))
        out["generate_beam"] = make({}).generate_beam(ids[0], images[0], num_beams=3).token_ids
    elif kind == "mpt":
        out["generate"] = make(DUAL).generate(ids[0], images[0]).token_ids
        out["generate_vcd"] = make(VCD).generate(ids[0], images[0]).token_ids
        out["generate_batch"] = toks(make(DUAL).generate_batch([(ids[0], images[0]), (ids[1], images[1]),
                                                                (req["text"], None)]))
        out["generate_beam"] = make({}).generate_beam(ids[0], images[0], num_beams=3).token_ids
    else:  # InstructBLIP, BLIP-2 OPT: query features computed outside the engine
        feats = req["feats"]
        out["generate_vcd"] = make(VCD).generate(ids, None, precomputed_feats=feats).token_ids
        eng = make({"use_dd": True})
        if jax_side:  # the JAX lockstep batch encodes every slot, which the adapter refuses
            dummy = np.zeros((1, 1, feats.shape[-1]), np.float32)
            out["generate_batch"] = [eng.generate(q, None, precomputed_feats=dummy).token_ids for q in req["text"]]
        else:
            out["generate_batch"] = toks(eng.generate_batch([(q, None) for q in req["text"]]))
        out["generate_beam"] = make({}).generate_beam(ids, precomputed_feats=feats[:1], num_beams=3).token_ids
    return out


def _four_ranks(rank, world, device, inputs, out_dir):
    """Everything the 4-rank spawn checks, on one rank; returns the tokens
    and errors the parent holds against JAX, and writes the arrays it holds
    against JAX's (the TP matmul outputs; on rank 0 the stepped params) to
    <out_dir>/rank<r>.npz. The ranks run while the parent computes the JAX
    side, so nothing of it is theirs."""
    from llava_align_tpu_torch.config import GenerationConfig as TGen
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.framework.optims import tree_leaves
    from llava_align_tpu_torch.ops import quant
    from llava_align_tpu_torch.parallel.mesh import axis_group, axis_rank, make_mesh
    from llava_align_tpu_torch.parallel.sharding import shard_params, unshard_params
    from llava_align_tpu_torch.train import trainer
    from llava_align_tpu_torch.utils.jax_params import from_jax_params

    mesh = make_mesh(model=2, data=2)
    group, r = axis_group(mesh, "model"), axis_rank(mesh, "model")
    out = {}

    # ---- int8_matmul_stacked_tp (held against JAX's by the parent)
    arrays = {}
    for name, h, wq, mode, aq in inputs["tp_matmul"]:
        h = torch.from_numpy(np.asarray(h))
        local = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _local_stack(wq, mode, r, 2).items()}
        if mode == "row":
            h = h[:, r * (h.shape[1] // 2) : (r + 1) * (h.shape[1] // 2)].contiguous()
        arrays[f"tp_{name}"] = quant.int8_matmul_stacked_tp(h, local, 1, group, mode, act_quant=aq).numpy()

    # ---- the engine's entry points, greedy tokens
    _, tcfg = inputs["cfgs"]
    tree = from_jax_params(inputs["tree"], device="cpu")
    imgs = inputs["images"]

    def engine(flags, params=tree, cfg=tcfg, m=mesh, do_sample=False, **kw):
        return DecodeEngine(params, cfg, _gen(TGen, do_sample=do_sample, **flags), bucket=8, mesh=m, **kw)

    dual = engine(DUAL)
    out["generate_dual"] = dual.generate(IDS, imgs[0]).token_ids
    out["generate_batch"] = [o.token_ids for o in dual.generate_batch(
        [(p, imgs[i] if i != 1 else None) for i, p in enumerate(PROMPTS)])]
    out["generate_batch_prefix"] = [o.token_ids for o in dual.generate_batch_prefix(PREFIX, SUFFIXES, imgs[0])]
    out["generate_beam"] = engine({}).generate_beam(IDS, imgs[0], num_beams=3).token_ids
    restore = _patch_port_noise(inputs["eps"])
    try:
        out["generate_vcd"] = engine(VCD).generate(IDS, imgs[0]).token_ids
    finally:
        restore()
    # VCD batch: one eps for the whole batch, drawn whole and sliced over 'data'
    vcd_q = [(p, imgs[i]) for i, p in enumerate(PROMPTS)]
    restore = _patch_port_noise(inputs["batch_eps"])
    try:
        out["vcd_batch"] = [o.token_ids for o in engine(VCD).generate_batch(vcd_q)]
    finally:
        restore()
    groups = [(PREFIX, GROUP_SUFFIXES[g], imgs[g]) for g in range(2)]
    out["kv_int8_groups"] = [o.token_ids for o in engine(DUAL, kv_quant="int8").generate_batch_groups(groups)]
    # sampled decodes under the 'data' split against the port's unsharded
    # engine, seed for seed: VCD generate_batch (the noise and the draws
    # share one stream; chunks of 2 and 1 questions) and
    # generate_batch_prefix (one group: the second slice's chunk is empty)
    sampled = []
    for m in (mesh, None):
        sampled.append(([o.token_ids for o in engine(VCD, m=m, do_sample=True).generate_batch(vcd_q)],
                        [o.token_ids for o in engine(DUAL, m=m, do_sample=True).generate_batch_prefix(
                            PREFIX, SUFFIXES, imgs[0])]))
    out["sampled"] = sampled

    # ---- one kv head over model = 2: k/v and the cache stay whole on each rank
    _, kv1_cfg = inputs["kv1_cfgs"]
    kv1_tree = from_jax_params(inputs["kv1_tree"], device="cpu")
    kv1 = engine(DUAL, params=kv1_tree, cfg=kv1_cfg)
    out["kv1_cache_heads"] = kv1.adapter.cache_kv_heads
    out["kv1_generate"] = kv1.generate(IDS, imgs[0]).token_ids
    out["kv1_groups"] = [o.token_ids for o in kv1.generate_batch_groups(groups)]
    kv1_specs = trainer.train_shardings(kv1_cfg, kv1_tree, 2)
    assert kv1_specs["llama"]["layers"]["k"] is None and kv1_specs["llama"]["layers"]["q"] is not None
    kv1_batch = trainer.batch_to_device(trainer.build_train_batch(kv1_cfg, inputs["samples"], pad_to=16), "cpu")
    stepped = []
    for m in (mesh, None):
        opt = trainer.make_optimizer(**inputs["opt_kw"])
        p = shard_params(kv1_tree, kv1_specs, m) if m is not None else from_jax_params(inputs["kv1_tree"], device="cpu")
        p, st, loss = trainer.make_train_step(kv1_cfg, opt, mesh=m)(p, opt.init(p), kv1_batch)
        with torch.no_grad():
            stepped.append((float(loss), [x.detach().clone() for x in tree_leaves(
                unshard_params(p, kv1_specs, mesh) if m is not None else p)], st))
    (l_tp, p_tp, _), (l_one, p_one, st_one) = stepped
    nu = [np.sqrt(x.double().numpy()) for x in tree_leaves(st_one["nu"])]
    top = max(x.max() for x in nu)
    diffs = [np.abs(a.numpy() - b.numpy()) for a, b in zip(p_tp, p_one)]
    noise = [(r > 0) & (r < 1e-6 * top) for r in nu]
    out["kv1_train"] = dict(loss=l_tp, loss_one=l_one,
                            err=max(float(d[~z].max(initial=0)) for d, z in zip(diffs, noise)),
                            noise_err=max(float(d[z].max(initial=0)) for d, z in zip(diffs, noise)))

    # ---- the int8 tree whose intermediate must lane-pad
    _, q_cfg = inputs["int8_cfgs"]
    q_eng = engine(DUAL, params=from_jax_params(inputs["int8_tree"], device="cpu"), cfg=q_cfg)
    out["int8_tp"] = bool(q_eng._int8_tp)
    out["int8_down_width"] = int(q_eng.params["llama"]["layers"]["down"]["q"].shape[2])
    out["int8_generate"] = q_eng.generate(IDS, imgs[0]).token_ids

    # ---- the other four adapters under data 2 x model 2 and data 1 x model 4
    from llava_align_tpu_torch.decoding import adapters

    meshes = {"data2_model2": mesh, "data1_model4": make_mesh(model=4, data=1)}
    for kind, fam in inputs["families"].items():
        cls, fcfg = getattr(adapters, fam["adapter"]), fam["cfg"]
        fparams = from_jax_params(fam["tree"], device="cpu")
        for name, m in meshes.items():
            def make(flags, m=m):
                return DecodeEngine(fparams, fcfg, _gen(TGen, **flags), adapter=cls(fcfg), bucket=8, mesh=m)

            restore = _patch_port_noise(fam["req"]["eps"]) if "eps" in fam["req"] else (lambda: None)
            try:
                out[f"{kind}:{name}"] = _family_tokens(kind, make, fam["req"])
            finally:
                restore()
            eng = make({})
            out[f"{kind}:{name}:layout"] = [eng.adapter.tp_layers, eng.adapter.cache_kv_heads, bool(eng._int8_tp)]

    # ---- one train step against JAX's unsharded step
    from llava_align_tpu_torch.config import LlavaConfig as TC

    cfg = TC.tiny(vocab_size=64)
    full = from_jax_params(inputs["tree"], device="cpu")
    specs = trainer.train_shardings(cfg, full, 2)
    params = shard_params(full, specs, mesh)
    opt = trainer.make_optimizer(**inputs["opt_kw"])
    step = trainer.make_train_step(cfg, opt, mesh=mesh)
    batch = trainer.batch_to_device(trainer.build_train_batch(cfg, inputs["samples"], pad_to=16), "cpu")
    state = opt.init(params)
    losses = []
    for _ in range(inputs["steps"]):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    with torch.no_grad():
        got = unshard_params(params, specs, mesh)
        out["losses"] = losses
        if rank == 0:
            arrays.update({f"param_{i}": x.numpy() for i, x in enumerate(tree_leaves(got))})
        # AdamW's global norm: the sharded tree's (norm_sync) == the whole tree's
        rng = np.random.default_rng(4)
        g_full = [torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)) for x in tree_leaves(full)]
        g_tree = _unflatten(full, g_full)
        g_local = tree_leaves(shard_params(g_tree, specs, mesh))
        whole = trainer.make_optimizer(max_grad_norm=1.0)
        out["global_norm"] = [float(opt.global_norm(g_local)), float(whole.global_norm(g_full))]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    return out


def _unflatten(like, leaves):
    """leaves (tree_leaves order) back into `like`'s structure."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)

    return walk(like)


def _inputs():
    """What the ranks take (no output of JAX's): the trees (numpy; the int8
    one quantized by the JAX package), images, eps, the TP matmul cases, the
    train samples and the four other families' trees and requests."""
    import jax
    from llava_align_tpu.ops import quant as jq

    _, tcfg = _cfgs()
    _, tcfg1 = _cfgs(kv_heads=1)
    _, tcfg8 = _cfgs(int8_tp=True)
    int8_tree = _tree(tcfg8, 2)
    int8_tree = dict(int8_tree, llama=jax.device_get(jq.quantize_llama_params(int8_tree["llama"], fuse=True)))
    H = tcfg.vision.image_size
    rng = np.random.default_rng(0)
    samples = [{"input_ids": [1, 5, S, 7 + i, 8, 9 + (i % 3), 11][: 5 + i % 3],
                "images": rng.normal(size=(3, H, H)).astype(np.float32)} for i in range(4)]
    families = {}
    for kind in FAMILIES:
        ft, name = _family_cfgs(kind)
        families[kind] = dict(cfg=ft, adapter=name, tree=_family_tree(kind, ft), req=_family_requests(kind, ft))
    return dict(tp_matmul=_tp_matmul_cases(), cfgs=(None, tcfg), tree=_tree(tcfg, 0), images=_images(),
                eps=_eps(), batch_eps=_eps(len(PROMPTS), seed=6), families=families,
                int8_cfgs=(None, tcfg8), int8_tree=int8_tree, kv1_cfgs=(None, tcfg1), kv1_tree=_tree(tcfg1, 3),
                opt_kw=dict(lr=LR, warmup_steps=0, total_steps=10, weight_decay=0.05, max_grad_norm=1.0),
                samples=samples, steps=1)


def _jax_noise(injected):
    """A stand-in for the JAX engine's add_diffusion_noise that adds the
    injected eps."""
    import jax.numpy as jnp
    from llava_align_tpu.ops import noise as jnoise

    def noise(images, rng, noise_step):
        assert images.shape == injected.shape, (images.shape, injected.shape)
        sqrt_ab, sqrt_1m_ab = (jnp.asarray(a) for a in jnoise.diffusion_schedule())
        t = jnp.asarray(noise_step, jnp.int32)
        return (sqrt_ab[t] * images.astype(jnp.float32)
                + sqrt_1m_ab[t] * jnp.asarray(injected)).astype(images.dtype)

    return noise


def _family_references(families) -> dict:
    """The unsharded JAX engine's tokens for each other family (run in a
    process of its own, beside the LLaVA references and the ranks)."""
    import jax
    import jax.numpy as jnp
    from llava_align_tpu.config import GenerationConfig as JGen
    from llava_align_tpu.decoding import adapters as jadapters
    from llava_align_tpu.decoding import engine as jengine_mod
    from llava_align_tpu.decoding.engine import DecodeEngine as JEngine

    want, saved = {}, jengine_mod.add_diffusion_noise
    for kind, fam in families.items():
        fj, name = _family_cfgs(kind, jax_side=True)
        jtree = jax.tree_util.tree_map(jnp.asarray, fam["tree"])
        cls = getattr(jadapters, name)

        def make(flags, jtree=jtree, fj=fj, cls=cls):
            return JEngine(jtree, fj, _gen(JGen, **flags), adapter=cls(fj), attn_impl="xla", bucket=8)

        jengine_mod.add_diffusion_noise = _jax_noise(fam["req"]["eps"]) if "eps" in fam["req"] else saved
        try:
            want[kind] = _family_tokens(kind, make, fam["req"], jax_side=True)
        finally:
            jengine_mod.add_diffusion_noise = saved
    return want


def _llava_references(inputs):
    """The JAX side of the LLaVA checks: the TP matmul outputs on a 2-device
    mesh, the unsharded engine's tokens and the unsharded train step.
    Returns (tokens, tp outputs, losses, nu, stepped params)."""
    import jax
    import jax.numpy as jnp
    from llava_align_tpu.config import GenerationConfig as JGen
    from llava_align_tpu.decoding import engine as jengine_mod
    from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
    from llava_align_tpu.ops import quant as jq
    from llava_align_tpu.parallel.mesh import make_mesh as jmesh
    from llava_align_tpu.train import trainer as jtrainer

    jcfg, _ = _cfgs()
    jcfg1, _ = _cfgs(kv_heads=1)
    jcfg8, _ = _cfgs(int8_tp=True)
    tree, kv1_tree, int8_tree = inputs["tree"], inputs["kv1_tree"], inputs["int8_tree"]
    imgs, eps, batch_eps = inputs["images"], inputs["eps"], inputs["batch_eps"]

    mesh = jmesh(model=2, data=1, devices=jax.devices()[:2])
    tp = {}
    for name, h, wq, mode, aq in inputs["tp_matmul"]:
        tp[name] = np.asarray(jq.int8_matmul_stacked_tp(jnp.asarray(h), jax.tree_util.tree_map(jnp.asarray, wq),
                                                        jnp.asarray(1, jnp.int32), mesh, mode, act_quant=aq))

    def jengine(flags, params=tree, cfg=jcfg):
        return JEngine(params, cfg, _gen(JGen, **flags), attn_impl="xla", bucket=8)

    dual = jengine(DUAL)
    want = {
        "generate_dual": dual.generate(IDS, imgs[0]).token_ids,
        "generate_batch": [o.token_ids for o in dual.generate_batch(
            [(p, imgs[i] if i != 1 else None) for i, p in enumerate(PROMPTS)])],
        "generate_batch_prefix": [o.token_ids for o in dual.generate_batch_prefix(PREFIX, SUFFIXES, imgs[0])],
        "generate_beam": jengine({}).generate_beam(IDS, imgs[0], num_beams=3).token_ids,
        "int8_generate": jengine(DUAL, int8_tree, jcfg8).generate(IDS, imgs[0]).token_ids,
        "kv1_generate": jengine(DUAL, kv1_tree, jcfg1).generate(IDS, imgs[0]).token_ids,
        "kv1_groups": [o.token_ids for o in jengine(DUAL, kv1_tree, jcfg1).generate_batch_groups(
            [(PREFIX, GROUP_SUFFIXES[g], imgs[g]) for g in range(2)])],
        "kv_int8_groups": [o.token_ids for o in JEngine(tree, jcfg, _gen(JGen, **DUAL), attn_impl="xla", bucket=8,
                                                        kv_quant="int8").generate_batch_groups(
            [(PREFIX, GROUP_SUFFIXES[g], imgs[g]) for g in range(2)])],
    }
    saved = jengine_mod.add_diffusion_noise
    try:
        jengine_mod.add_diffusion_noise = _jax_noise(eps)
        want["generate_vcd"] = jengine(VCD).generate(IDS, imgs[0]).token_ids
        jengine_mod.add_diffusion_noise = _jax_noise(batch_eps)
        want["vcd_batch"] = [o.token_ids for o in jengine(VCD).generate_batch(
            [(p, imgs[i]) for i, p in enumerate(PROMPTS)])]
    finally:
        jengine_mod.add_diffusion_noise = saved

    opt = jtrainer.make_optimizer(**inputs["opt_kw"])
    step = jtrainer.make_train_step(jcfg, opt, attn_impl="xla", donate=False)
    p, s, losses = tree, opt.init(tree), []
    for _ in range(inputs["steps"]):
        p, s, loss = step(p, s, jtrainer.build_train_batch(jcfg, inputs["samples"], pad_to=16))
        losses.append(float(loss))
    adam = next(x for x in jax.tree_util.tree_leaves(s, is_leaf=lambda n: hasattr(n, "nu")) if hasattr(x, "nu"))
    nu = [np.asarray(x) for x in jax.tree_util.tree_leaves(adam.nu)]
    return want, tp, losses, nu, [np.asarray(x) for x in jax.tree_util.tree_leaves(jax.device_get(p))]


@pytest.fixture(scope="module")
def parallel_run(tmp_path_factory):
    """The 4-rank spawn and the JAX side, run side by side: the ranks start
    first (one thread each), the other families' JAX references run in a
    process of their own, the LLaVA references here. Then the ranks' arrays are held against
    JAX's: each rank's TP matmul output (fp32: relative to the output's
    largest element, |y| ~ 10 here; W8A8: bit for bit) and, on rank 0, the
    stepped params' distance to JAX's. Returns ((inputs, tokens, losses,
    nu), rank results)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    inputs = _inputs()
    out_dir = tmp_path_factory.mktemp("four_ranks")
    ranks = start(_four_ranks, 4, (inputs, str(out_dir)), device="cpu", timeout=RANK_TIMEOUT)
    try:
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            families = pool.submit(_family_references, inputs["families"])
            want, tp, losses, nu, params = _llava_references(inputs)
            want["families"] = families.result()
        results = ranks.join()
    finally:
        ranks.stop()
    for rank, res in enumerate(results):
        arrays = np.load(out_dir / f"rank{rank}.npz")
        r = rank % 2  # the 'model' coordinate
        for name, _, _, mode, aq in inputs["tp_matmul"]:
            got, full = arrays[f"tp_{name}"], tp[name]
            w = full[:, r * (full.shape[1] // 2) : (r + 1) * (full.shape[1] // 2)] if mode == "column" else full
            res[f"tp_{name}"] = (bool(np.array_equal(got, w)) if aq
                                 else float(np.abs(got - w).max() / np.abs(w).max()))
        res["param_diff"] = ([np.abs(arrays[f"param_{i}"] - w) for i, w in enumerate(params)]
                             if rank == 0 else None)
    return (inputs, want, losses, nu), results


@pytest.fixture(scope="module")
def jax_reference(parallel_run):
    return parallel_run[0]


@pytest.fixture(scope="module")
def four_ranks(parallel_run):
    return parallel_run[1]


def test_int8_matmul_stacked_tp_matches_jax(four_ranks):
    for res in four_ranks:
        for name, _, _, _, aq in _tp_matmul_cases():
            if aq:
                assert res[f"tp_{name}"] is True, name  # W8A8: bit for bit
            else:
                assert res[f"tp_{name}"] <= 1e-5, (name, res[f"tp_{name}"])


@pytest.mark.parametrize("entry", ["generate_dual", "generate_vcd", "generate_batch", "generate_batch_prefix",
                                   "generate_beam", "int8_generate", "kv1_generate", "kv1_groups", "vcd_batch",
                                   "kv_int8_groups"])
def test_sharded_engine_tokens_equal_unsharded_jax(four_ranks, jax_reference, entry):
    want = jax_reference[1][entry]
    for res in four_ranks:  # every rank returns the whole result
        assert res[entry] == want, (entry, res[entry], want)


def test_sharded_engine_modes_equal_unsharded_port(four_ranks):
    for res in four_ranks:
        (batch, prefix), (batch_one, prefix_one) = res["sampled"]
        assert batch == batch_one and prefix == prefix_one, res["sampled"]
        assert res["kv1_cache_heads"] == 1  # one kv head: the cache holds it whole on each rank
        # intermediate 160 per shard is not lane-aligned: padded to 256, then TP
        assert res["int8_tp"] and res["int8_down_width"] == 256


@pytest.mark.parametrize("mesh_name", FAMILY_MESHES)
@pytest.mark.parametrize("kind", FAMILIES)
def test_family_tp_tokens_equal_unsharded_jax(four_ranks, jax_reference, kind, mesh_name):
    want = jax_reference[1]["families"][kind]
    for res in four_ranks:  # every rank returns the whole result
        assert res[f"{kind}:{mesh_name}"] == want, (kind, mesh_name, res[f"{kind}:{mesh_name}"], want)


def test_family_tp_layouts(four_ranks):
    """Every family's layer stacks split over 'model' (int8 Qwen through the
    TP kernels, its MLP lane-padded at model 4); each rank's cache holds
    the adapter's kv heads: Qwen's and OPT's H / m, MPT's all of them (the
    attention runs whole), InstructBLIP's LLaMA K / m where K splits, else
    all (the tiny config's 2 kv heads at model 4)."""
    heads = {"qwen": (2, 1), "qwen_int8": (2, 1), "mpt": (4, 4), "blip": (1, 2), "opt": (2, 1)}
    for res in four_ranks:
        for kind in FAMILIES:
            for name, k in zip(FAMILY_MESHES, heads[kind]):
                assert res[f"{kind}:{name}:layout"] == [True, k, kind == "qwen_int8"], (kind, name)


def test_family_specs_match_jax():
    """The spec functions (qwen/mpt/opt_param_shardings, completed) and the
    adapters' param_shardings against JAX's, leaf for leaf, on each
    family's tree. The one departure: the int8 fused w1|w2 ('w12'), which
    JAX's qwen_param_shardings names no spec for (GSPMD replicates it),
    splits block by block, as LLaVA's gate|up does."""
    import jax
    from llava_align_tpu.decoding import adapters as jadapters
    from llava_align_tpu.parallel import sharding as jshd
    from llava_align_tpu.parallel.mesh import make_mesh as jmesh

    from llava_align_tpu_torch.decoding import adapters as tadapters
    from llava_align_tpu_torch.parallel import sharding as tshd
    from llava_align_tpu_torch.utils.jax_params import from_jax_params

    mesh = jmesh(model=2, data=1, devices=jax.devices()[:2])
    stub = _StubMesh(1, 2, 0)
    lm = {"qwen": "qwen", "mpt": "mpt", "opt": "lm"}
    for kind in FAMILIES:
        (jc, name), (tc, _) = _family_cfgs(kind, jax_side=True), _family_cfgs(kind)
        tree = _family_tree(kind, tc)
        ttree = from_jax_params(tree, device="cpu")
        want = getattr(jadapters, name)(jc).param_shardings(tree, mesh)
        got = getattr(tadapters, name)(tc).param_shardings(ttree, stub)
        if kind == "qwen_int8":
            w12 = got["qwen"]["layers"]["w12"]
            half = tc.text.intermediate_size // 2
            assert w12["q"] == w12["s"] == tshd.Shard(1, blocks=(half, half)), w12
            assert jshd.qwen_param_shardings(mesh)["layers"].get("w12") is None
            rep = {"q": None, "s": None}
            got = dict(got, qwen=dict(got["qwen"], layers=dict(got["qwen"]["layers"], w12=rep)))
        _assert_specs_equal(got, want, tree)
        key = lm.get(kind.split("_")[0])
        if key is not None and kind != "qwen_int8":  # the spec functions themselves
            fn = {"qwen": lambda: tshd.qwen_param_shardings(tc.text), "mpt": tshd.mpt_param_shardings,
                  "opt": tshd.opt_param_shardings}[kind]
            jfn = getattr(jshd, f"{kind}_param_shardings")
            _assert_specs_equal(tshd.complete_shardings(ttree, {key: fn()}),
                                jshd.complete_shardings(tree, {key: jfn(mesh)}, mesh), tree)


def test_sharded_train_step_matches_unsharded_jax(four_ranks, jax_reference):
    _, _, want_losses, nu = jax_reference
    for res in four_ranks:
        np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-6)
        a, b = res["global_norm"]
        assert abs(a - b) <= 1e-6 * b, (a, b)
    rms = [np.sqrt(np.asarray(n, np.float64)) for n in nu]
    top = max(x.max() for x in rms)
    n_noise = 0
    for d, r in zip(four_ranks[0]["param_diff"], rms):
        d, noise = np.asarray(d), (r > 0) & (r < 1e-6 * top)
        n_noise += int(noise.sum())
        assert d[~noise].max(initial=0) <= 1e-5, d[~noise].max(initial=0)
        assert d[noise].max(initial=0) <= 2 * LR
    assert n_noise < 1e-3 * sum(x.size for x in rms)
    for res in four_ranks:  # whole kv heads: the step against the port's own unsharded one
        t = res["kv1_train"]
        assert abs(t["loss"] - t["loss_one"]) <= 1e-6 * t["loss_one"], t
        assert t["err"] <= 1e-5 and t["noise_err"] <= 2 * LR, t


# ---------------------------------------------------------------------------
# one spawn of 2 ranks: the POPE runner with --dist auto
# ---------------------------------------------------------------------------


def _pope_args(question_file, answers_file, dist):
    from llava_align_tpu_torch.runners import pope

    args = pope.build_parser().parse_args(
        ["--model-path", "random:tiny", "--device", "cpu", "--question-file", question_file,
         "--answers-file", answers_file, "--dist", dist, "--synthetic-images", "--use_dd", "--use_dd_unk",
         "--max_new_tokens", "4", "--temperature", "0", "--calibrate", "--batch-size", "1"])
    args.group_by_image = False
    return args


def _pope_rank(rank, world, device, question_file, answers_file):
    from llava_align_tpu_torch.runners import pope

    return pope.run(_pope_args(question_file, answers_file, "auto"))


def test_pope_dist_auto_merges_into_the_one_rank_answers(tmp_path, monkeypatch):
    from llava_align_tpu_torch.evals.pope import load_jsonl
    from llava_align_tpu_torch.runners import pope

    qf = tmp_path / "q.jsonl"
    qf.write_text("".join(json.dumps({"question_id": i, "image": f"img{i // 3}.jpg", "text": f"Is there a cat #{i}?",
                                      "label": "yes" if i % 2 else "no"}) + "\n" for i in range(6)))
    merged = str(tmp_path / "dist" / "answers.jsonl")
    ranks = start(_pope_rank, 2, (str(qf), merged), device="cpu", timeout=RANK_TIMEOUT)
    try:  # the one-rank run while the ranks run
        for name in ("RANK", "WORLD_SIZE"):
            monkeypatch.delenv(name, raising=False)
        one = pope.run(_pope_args(str(qf), str(tmp_path / "one.jsonl"), "none"))
        paths = ranks.join()
    finally:
        ranks.stop()
    assert paths[0] == merged and paths[1] == str(tmp_path / "dist" / "answers.rank1-of-2.jsonl")
    got, want = load_jsonl(merged), load_jsonl(one)
    assert [r["question_id"] for r in got] == list(range(6))
    assert got == want
    assert os.path.exists(str(tmp_path / "dist" / "answers.rank0-of-2.jsonl"))
