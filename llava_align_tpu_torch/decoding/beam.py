"""Beam-search decoding (single branch) for the DecodeEngine (torch twin of
llava_align_tpu/decoding/beam.py).

The reference's BLIP-2 family captions with HF beam search (LAVIS
blip2_vicuna_instruct.py:245, num_beams=5); its VCD/VDD sampler never
combines with beams (it patches `sample` only), so the contrastive branches
are excluded by design.

Beams ride the batch axis: the cache rows are reordered every step by the
beams' parents, candidates are the top 2K of the flattened [K*V] scores,
and the finished hypotheses are a fixed [K] score buffer merged with each
step's eos candidates. Semantics are HF `generate(num_beams=K,
do_sample=False, early_stopping=False)`: scores are summed fp32 logprobs,
a finished hypothesis is normalized by (n + 1) ** length_penalty, eos
candidates finish only from the top-K ranks, and the loop stops when the
worst kept hypothesis can no longer be beaten (HF's is_done). Every top-k
here breaks ties as jax.lax.top_k does, the lower index first (a stable
descending sort; torch.topk promises no order among equal values).

The loop is an eager Python loop with one host read a step (`done`), as
the engine's other loops read their tokens; the JAX package runs it on the
device in lax.while_loop. Unlike it, the loop skips the forward after the
last step. Under DecodeEngine(mesh=...) the adapter the loop calls carries
the mesh (JAX's beam takes it as tp_mesh), so its forwards run
tensor-parallel and every rank gets the same beams.
"""

from __future__ import annotations

import torch

NEG = -1.0e9


def _top(x: torch.Tensor, k: int):
    """(values, indices) of the k largest of 1-D x, the lower index first
    among equal values (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _gather_cache(cache: dict, parents: torch.Tensor) -> dict:
    """Reorder the cache's beam rows ([L, K, S, H, Dh]) by parent index."""
    return {name: c.index_select(1, parents) for name, c in cache.items()}


def make_beam_fn(
    adapter,
    *,
    num_beams: int,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
    length_penalty: float = 1.0,
    min_new_tokens: int = 0,
    attn_impl: str = "auto",
    cache_len: int = 0,
):
    """Returns fn(params, cache_1row, first_logits [1, V], length_1 [1]) →
    (best_seq [T], best_len, best_score). The caller prefills ONE row; the
    fn tiles it to K beam rows. min_new_tokens masks eos until that many
    tokens are generated (HF MinNewTokensLengthLogitsProcessor; LAVIS
    captioning's min_length). After a call, fn.hypotheses holds what the
    best was chosen from: (seqs [2K, T], lengths [2K], normalized scores
    [2K]; the first K the finished hypotheses, which ended in eos, the last
    K the running beams, NEG where a slot holds none)."""
    K, T, lp = num_beams, max_new_tokens, length_penalty

    def beam_fn(params, cache1, first_logits, length1):
        dev = first_logits.device
        cache = {name: c.repeat_interleave(K, dim=1) for name, c in cache1.items()}
        lengths = length1.long().repeat_interleave(K)
        logits = first_logits.repeat_interleave(K, dim=0)
        V = logits.shape[-1]
        mask_eos = min_new_tokens > 0 and 0 <= eos_token_id < V
        seq = torch.full((K, T), pad_token_id, dtype=torch.long, device=dev)
        scores = torch.full((K,), NEG, dtype=torch.float32, device=dev)
        scores[0] = 0.0
        fin_scores = torch.full((K,), NEG, dtype=torch.float32, device=dev)
        fin_seq = torch.full((K, T), pad_token_id, dtype=torch.long, device=dev)
        fin_len = torch.zeros((K,), dtype=torch.long, device=dev)
        rank = torch.arange(2 * K, device=dev)
        n, done = 0, False
        while not done and n < T:
            gen_len = torch.tensor(n + 1, dtype=torch.float32, device=dev) ** lp
            logprobs = torch.log_softmax(logits.float(), dim=-1)
            if mask_eos and n < min_new_tokens:
                logprobs[:, eos_token_id] = NEG
            vals, idx = _top((scores[:, None] + logprobs).reshape(-1), 2 * K)
            tok, parent = idx % V, idx // V
            is_eos = tok == eos_token_id

            # finished candidates: eos within the top-K ranks
            cand_fin = torch.where(is_eos & (rank < K), vals / gen_len, NEG)
            merged_scores = torch.cat([fin_scores, cand_fin])
            merged_seq = torch.cat([fin_seq, seq[parent]])  # eos not written
            merged_len = torch.cat([fin_len, torch.full((2 * K,), n, dtype=torch.long, device=dev)])
            fin_scores, fin_idx = _top(merged_scores, K)
            fin_seq, fin_len = merged_seq[fin_idx], merged_len[fin_idx]

            # running beams: the best K non-eos candidates
            scores, sel = _top(torch.where(is_eos, NEG, vals), K)
            parents, toks = parent[sel], tok[sel]
            seq = seq[parents]
            seq[:, n] = toks

            # stop: K hypotheses held and none improvable (HF
            # BeamHypotheses.is_done, early_stopping=False); the step's
            # one host read
            n_fin = (fin_scores > NEG / 2).sum()
            done = bool((n_fin >= K) & (fin_scores[K - 1] >= scores[0] / gen_len))
            n += 1
            if done or n >= T:
                break
            cache = _gather_cache(cache, parents)
            emb = adapter.embed_tokens(params, toks[:, None])
            hidden, cache = adapter.forward(params, emb, lengths[:, None], cache, lengths,
                                            attn_impl=attn_impl, max_seq_len=cache_len)
            logits = adapter.logits(params, hidden[:, 0])
            lengths = lengths + 1

        # finalize: the running beams compete with the finished ones unless
        # done (HF finalize)
        run_norm = scores / torch.tensor(max(n, 1), dtype=torch.float32, device=dev) ** lp
        if done:
            run_norm = torch.full_like(run_norm, NEG)
        all_scores = torch.cat([fin_scores, run_norm])
        all_seq = torch.cat([fin_seq, seq])
        all_len = torch.cat([fin_len, torch.full((K,), n, dtype=torch.long, device=dev)])
        best = torch.argmax(all_scores)  # the first of equal maxima, as jnp.argmax
        beam_fn.hypotheses = (all_seq, all_len, all_scores)
        return all_seq[best], int(all_len[best]), all_scores[best]

    beam_fn.hypotheses = None
    return beam_fn
