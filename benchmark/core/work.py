"""The yardstick's arithmetic: the card's peaks, the least time a call's
work could take on them, the operations and bytes of the port's functions
counted from the shapes at each call, and the model FLOPs of a served
call counted from the configuration and the positions it processed."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

# One NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_seconds(nbytes: float, ops: float) -> float:
    """The least time on the card: bytes at the memory rate or operations at
    the bf16 tensor-core rate, whichever takes longer."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_BF16_FLOPS)


def roofline_share(works: Iterable[tuple]) -> Optional[float]:
    """100 x the summed bounds over the summed device time of
    (ops, bytes, device seconds) calls; None without device time."""
    bound = dev = 0.0
    for ops, nbytes, seconds in works:
        bound += bound_seconds(nbytes, ops)
        dev += seconds
    return 100.0 * bound / dev if dev > 0 else None


def linear_work(rows: int, out_features: int, in_features: int, act_bytes: int, weight_bytes: int,
                out_bytes: int) -> tuple:
    """(ops, bytes) of rows x [in] times a weight [out, in]: the activations
    read once (act_bytes an element), the weight as stored (weight_bytes in
    all, scales included), the output written once (out_bytes an element)."""
    ops = 2.0 * rows * out_features * in_features
    nbytes = rows * in_features * act_bytes + weight_bytes + rows * out_features * out_bytes
    return ops, float(nbytes)


def causal_pairs(S: int) -> int:
    """Query-key pairs of causal attention over S positions."""
    return S * (S + 1) // 2


def attention_work(B: int, S: int, H: int, K: int, Dh: int, elem: int, cache_write: bool = False,
                   shared_lens: Sequence[int] = (), shared_bytes: int = 0) -> tuple:
    """(ops, bytes) of a causal prefill over B rows of S positions, H query
    heads over K kv heads of width Dh: QK^T and PV over the causal pairs,
    plus each row's S queries against its shared prefix of shared_lens[b]
    keys; q, k and v read once, the output written once (elem bytes an
    element), the keys and values written into the cache when cache_write,
    and shared_bytes of shared segments read once."""
    pairs = B * causal_pairs(S) + S * sum(shared_lens)
    ops = 4.0 * H * Dh * pairs
    nbytes = B * S * Dh * (2 * H + 2 * K) * elem + (2 * B * S * K * Dh * elem if cache_write else 0) + shared_bytes
    return ops, float(nbytes)


def span_flops(family, start: int, n: int) -> float:
    """Model FLOPs of n decoder positions after `start` already cached:
    position start + j attends start + j positions (j = 1..n)."""
    a = family.position_flops(0)
    b = family.position_flops(1) - a
    return n * a + b * (n * start + n * (n + 1) / 2)


def common_prefix(rows: Sequence[Sequence[int]]) -> int:
    """The longest common prefix of rows, each keeping at least one token."""
    short = min(len(r) for r in rows)
    p = 0
    while p < short - 1 and all(r[p] == rows[0][p] for r in rows):
        p += 1
    return p


def call_flops(family, traffic, call, tokens: Sequence[Sequence[int]]) -> float:
    """Model FLOPs of one served call: the tower on every image it encodes
    (twice under VCD: the noised copy), every branch row's prompt
    positions (a group's shared prefix once a group), the head at each
    row's last prompt position and at every decode step, and every decode
    row's step (the steps after the last token are not run)."""
    branches = traffic.branches
    n_img_kinds = sum(1 for k in branches if k in ("main", "cd"))
    total = len(call.images) * n_img_kinds * family.tower_flops()
    head = family.head_flops()
    per_q = [traffic.per_group] * traffic.groups if traffic.entry_groups else [1] * len(call.questions)
    qi = 0
    for n_q in per_q:
        qs = call.questions[qi: qi + n_q]
        toks = tokens[qi: qi + n_q]
        qi += n_q
        prefix = qs[0].ids[: common_prefix([q.ids for q in qs])] if traffic.entry_groups else []
        for kind in branches:
            rows = [q.ids if kind in ("main", "cd") else q.branch_ids[kind] for q in qs]
            # a group shares its image prefix, and the 'none' rows the same
            # prefix with the image taken out; explicit 'unk' ids are never split
            if kind in ("main", "cd"):
                shared = traffic.expanded(prefix)
            elif kind == "none":
                shared = len(family.none_ids(prefix))
            else:
                shared = 0
            total += span_flops(family, 0, shared)
            for r, t in zip(rows, toks):
                n = traffic.expanded(r)
                total += span_flops(family, shared, n - shared) + head
                steps = max(len(t) - 1, 0)
                total += span_flops(family, n, steps) + steps * head
    return total
