"""GPT-2 and the GPT dialogue model in the port (models/gpt2.py) against
the JAX package's on the CPU, at the tiny config, from the same numpy tree
(the port's own init, carried into both) and seeded inputs.

JAX references: one compiled program (tests/lavis_ref.run_all) for
forward (padded rows), logits, a decode_step loop over a prefix, and
dialogue_forward with its labels (the LM loss over labels != -1 plus the
video MSE) and without; dialogue_generate is the JAX package's own greedy
loop (its step jitted with tests/lavis_ref.FAST_COMPILE), without eos and
with an eos that ends one row early. Tolerances: logits within 1e-5,
losses within 1e-6, generated tokens exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import close, fast_jit, np_tree, run_all
from llava_align_tpu.models import gpt2 as jg
from llava_align_tpu_torch.models import gpt2 as tg
from llava_align_tpu_torch.utils.jax_params import from_jax_params

B, S, SV, ST, NEW = 2, 7, 3, 5, 6


def _t(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


@pytest.fixture(scope="module")
def ref():
    cfg, tcfg = jg.GptDialogueConfig.tiny(), tg.GptDialogueConfig.tiny()
    tree = np_tree(tg.dialogue_init(tcfg, device="cpu", seed=0))
    rng = np.random.default_rng(0)
    D, V, Fv = cfg.gpt.hidden_size, cfg.gpt.vocab_size, cfg.len_video_ft
    data = {"emb": rng.standard_normal((B, S, D)).astype(np.float32), "amask": np.ones((B, S), np.int32),
            "ids": rng.integers(7, V, (B, ST)).astype(np.int32),
            "fts": rng.standard_normal((B, SV, Fv)).astype(np.float32),
            "dmask": np.ones((B, SV + ST), np.int32), "types": rng.integers(0, 7, (B, SV + ST)).astype(np.int32),
            "labels": np.full((B, SV + ST), -1, np.int32)}
    data["amask"][1, 5:] = 0
    data["dmask"][1, -2:] = 0
    data["labels"][:, SV + 2:] = rng.integers(7, V, (B, ST - 2))
    J = {k: jnp.asarray(x) for k, x in data.items()}

    def program(p):
        g, c = p["gpt"], cfg.gpt
        hidden = jg.forward(g, c, J["emb"], attention_mask=J["amask"])
        cache, steps = jg.init_cache(c, B, S + 2), []
        for t in range(S):
            lg, cache = jg.decode_step(g, c, J["emb"][:, t], jnp.asarray(t, jnp.int32), cache)
            steps.append(lg)
        return {"hidden": hidden, "logits": jg.logits(g, hidden), "steps": jnp.stack(steps, 1),
                "dialogue": jg.dialogue_forward(p, cfg, J["ids"], J["fts"], J["dmask"], J["types"], J["labels"]),
                "no_labels": jg.dialogue_forward(p, cfg, J["ids"], J["fts"])}

    want = run_all({"gpt": (program, tree)})["gpt"]
    with fast_jit():
        want["gen"] = jg.dialogue_generate(tree, cfg, data["ids"], data["fts"], max_new_tokens=NEW)
        eos = int(want["gen"][0, 1])  # row 0 ends at its second token
        want["gen_eos"] = (eos, jg.dialogue_generate(tree, cfg, data["ids"], data["fts"], max_new_tokens=NEW,
                                                     eos_token_id=eos))
    return want, tree, data


def test_forward_and_decode_steps_match_jax(ref):
    want, tree, data = ref
    cfg, d = tg.GptDialogueConfig.tiny().gpt, _t(data)
    g = from_jax_params(tree, device="cpu")["gpt"]
    hidden = tg.forward(g, cfg, d["emb"], attention_mask=d["amask"])
    close(hidden, want["hidden"], "forward")
    close(tg.logits(g, hidden), want["logits"], "logits")
    cache = tg.init_cache(cfg, B, S + 2, device="cpu")
    for t in range(S):
        lg, cache = tg.decode_step(g, cfg, d["emb"][:, t], t, cache)
        close(lg, want["steps"][:, t], f"decode_step {t}")
    # a prefix forward that fills the cache, then a step: the same logits
    cache = tg.init_cache(cfg, B, S + 2, device="cpu")
    tg.forward(g, cfg, d["emb"][:, : S - 1], cache=cache)
    close(tg.decode_step(g, cfg, d["emb"][:, S - 1], S - 1, cache)[0], want["steps"][:, S - 1], "prefilled step")


def test_dialogue_forward_matches_jax(ref):
    want, tree, data = ref
    cfg, d = tg.GptDialogueConfig.tiny(), _t(data)
    p = from_jax_params(tree, device="cpu")
    out = tg.dialogue_forward(p, cfg, d["ids"], d["fts"], d["dmask"], d["types"], d["labels"])
    for k in ("loss", "video_loss"):
        close(out[k], want["dialogue"][k], k, rtol=1e-6, atol=0)
    close(out["logits"], want["dialogue"]["logits"], "logits")
    bare = tg.dialogue_forward(p, cfg, d["ids"], d["fts"])
    close(bare["loss"], want["no_labels"]["loss"], "video loss alone", rtol=1e-6, atol=0)
    close(bare["loss"], bare["video_loss"], "no labels: the video loss", atol=0)


def test_dialogue_generate_matches_jax_tokens(ref):
    """Greedy tokens equal JAX's loop; with an eos, row 0 ends early and
    repeats eos while row 1 runs on."""
    want, tree, data = ref
    cfg, p = tg.GptDialogueConfig.tiny(), from_jax_params(tree, device="cpu")
    got = tg.dialogue_generate(p, cfg, data["ids"], data["fts"], max_new_tokens=NEW)
    assert got.dtype == np.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got, want["gen"])
    eos, w = want["gen_eos"]
    got = tg.dialogue_generate(p, cfg, data["ids"], data["fts"], max_new_tokens=NEW, eos_token_id=eos)
    np.testing.assert_array_equal(got, w)
    assert (got[0, 1:] == eos).all() and got.shape[1] > 2
