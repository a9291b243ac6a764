"""Port parity: DecodeEngine.generate_beam of llava_align_tpu_torch is
token-exact against the JAX engine's on a tiny fp32 LLaMA (the
InstructBLIP adapter, text-only prompts), for num_beams in {1, 2, 3, 5},
length_penalty in {0.5, 1, 2} and min_new_tokens; with a planted tie (two
equal lm_head and embedding rows, so that only the order among equal
scores decides the tokens); and against HF transformers
generate(num_beams=K) on shared weights, as tests/test_beam.py holds the
JAX engine. The port's top-k order is held to jax.lax.top_k's on arrays
full of ties, and a multi-branch config is refused as JAX refuses it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.config import GenerationConfig as JGen
from llava_align_tpu.decoding.adapters import InstructBlipAdapter as JAdapter
from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
from llava_align_tpu.models import llama as jllama
from llava_align_tpu.models.instructblip import InstructBlipConfig as JCfg
from llava_align_tpu_torch.config import GenerationConfig as TGen
from llava_align_tpu_torch.config import LlamaConfig as TLlamaCfg
from llava_align_tpu_torch.decoding import beam as tbeam
from llava_align_tpu_torch.decoding.adapters import InstructBlipAdapter as TAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine
from llava_align_tpu_torch.models.instructblip import InstructBlipConfig as TCfg
from llava_align_tpu_torch.utils.hf_convert import convert_llama
from llava_align_tpu_torch.utils.jax_params import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False

VOCAB = 61
EOS = 2
JCFG, TCFG = JCfg.tiny(vocab_size=VOCAB), TCfg.tiny(vocab_size=VOCAB)
TIE = (7, 9)  # the planted tie: equal lm_head and embedding rows


def _llama(tie: bool = False):
    jp = jax.device_get(jllama.init(jax.random.PRNGKey(3), JCFG.text))
    if tie:
        a, b = TIE
        jp = dict(jp, embed=np.array(jp["embed"]), lm_head=np.array(jp["lm_head"]))
        jp["lm_head"][a] = jp["lm_head"][b] = 4.0 * jp["lm_head"][b]
        jp["embed"][a] = jp["embed"][b]
    return {"llama": jp}


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, tie in (("plain", False), ("tie", True)):
        jp = _llama(tie)
        out[name] = (jp, from_jax_params(jp, device="cpu"))
    return out


def _gen(cls, max_new, **kw):
    return cls(max_new_tokens=max_new, do_sample=False, eos_token_id=EOS, pad_token_id=0, **kw)


def _beams(trees, tree, ids, max_new, **kw):
    jp, tp = trees[tree]
    jeng = JEngine(jp, JCFG, _gen(JGen, max_new), adapter=JAdapter(JCFG), attn_impl="xla", bucket=8)
    teng = TEngine(tp, TCFG, _gen(TGen, max_new), adapter=TAdapter(TCFG), bucket=8)
    # text-only prompts: no sentinel, so the dummy features are never read
    # (the JAX engine would run the adapter's tower on a zero image without them)
    dummy = np.zeros((1, 1, JCFG.text.hidden_size), np.float32)
    return (teng.generate_beam(ids, precomputed_feats=dummy, **kw),
            jeng.generate_beam(ids, precomputed_feats=dummy, **kw))


CASES = [  # (seed, num_beams, length_penalty, min_new_tokens, max_new)
    (0, 1, 1.0, 0, 8),
    (1, 2, 0.5, 0, 10),
    (2, 3, 1.0, 0, 8),
    (3, 3, 2.0, 4, 10),
    (4, 5, 1.0, 0, 12),
    (5, 5, 0.5, 6, 9),
    (6, 5, 2.0, 0, 8),
]


@pytest.mark.parametrize("seed,num_beams,lp,min_new,max_new", CASES)
def test_generate_beam_token_exact_vs_jax(trees, seed, num_beams, lp, min_new, max_new):
    ids = [1] + np.random.default_rng(seed).integers(3, VOCAB, size=5).tolist()
    got, want = _beams(trees, "plain", ids, max_new, num_beams=num_beams, length_penalty=lp,
                       min_new_tokens=min_new)
    assert got.token_ids == want.token_ids
    assert got.num_generated == want.num_generated and got.prompt_length == want.prompt_length
    assert got.first_scores_top_probs.shape == want.first_scores_top_probs.shape == (0,)
    assert len(got.token_ids) >= min(min_new, max_new)


@pytest.mark.parametrize("num_beams", [3, 5])
def test_generate_beam_planted_tie_vs_jax(trees, num_beams):
    """Tokens 7 and 9 have one lm_head row and one embedding: a beam that
    takes either scores exactly the same, so the order among equal scores
    (jax.lax.top_k: the lower index first) decides which survives."""
    a, b = TIE
    ids = [1, 12, 30, 44, 51]
    got, want = _beams(trees, "tie", ids, 8, num_beams=num_beams)
    assert got.token_ids == want.token_ids
    assert a in got.token_ids and b not in got.token_ids  # the tie did decide, the lower id first


@pytest.mark.parametrize("seed", range(4))
def test_top_order_matches_lax_top_k(seed):
    """Values drawn from 5 levels, so most are tied: the same values and
    the same indices, in the same order."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 5, size=200).astype(np.float32)
    for k in (1, 6, 10, 200):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = tbeam._top(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_generate_beam_refuses_contrastive_branches(trees):
    _, tp = trees["plain"]
    for flags in ({"use_dd": True}, {"use_cd": True}):
        eng = TEngine(tp, TCFG, _gen(TGen, 4, **flags), adapter=TAdapter(TCFG), bucket=8)
        with pytest.raises(ValueError, match="single-branch"):
            eng.generate_beam([1, 5, 6], num_beams=2)


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, head_dim=12, bos_token_id=1,
        eos_token_id=EOS, pad_token_id=0, attn_implementation="eager",
    )).eval()
    tcfg = TLlamaCfg(vocab_size=VOCAB, hidden_size=48, intermediate_size=96, num_layers=2, num_heads=4,
                     num_kv_heads=4, head_dim=12, dtype=torch.float32)
    params = {"llama": convert_llama({k: v.detach() for k, v in hf.state_dict().items()}, tcfg, device="cpu")}
    return hf, dataclasses.replace(TCFG, text=tcfg), params


@pytest.mark.parametrize("seed,num_beams,max_new,lp,min_new", [
    (0, 3, 8, 1.0, 0), (2, 5, 6, 1.0, 0), (7, 4, 10, 0.5, 0), (11, 3, 8, 1.0, 5),
])
def test_generate_beam_matches_hf(hf_model, seed, num_beams, max_new, lp, min_new):
    hf, cfg, params = hf_model
    ids = [1] + np.random.default_rng(seed).integers(3, VOCAB, size=5).tolist()
    with torch.no_grad():
        out = hf.generate(input_ids=torch.tensor([ids]), num_beams=num_beams, max_new_tokens=max_new,
                          do_sample=False, early_stopping=False, length_penalty=lp,
                          min_new_tokens=min_new, num_return_sequences=1)
    row = out[0, len(ids):].tolist()
    want = row[: row.index(EOS)] if EOS in row else row  # pads only follow eos
    eng = TEngine(params, cfg, _gen(TGen, max_new), adapter=TAdapter(cfg), bucket=8)
    got = eng.generate_beam(ids, num_beams=num_beams, length_penalty=lp, min_new_tokens=min_new).token_ids
    assert got == want
