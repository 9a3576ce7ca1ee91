"""Batched Smith-Waterman local alignment on the accelerator.

Powers the exon-classification realignment path (the capability behind the
reference's broken ``align_lpa`` driver, SURVEY §3.5): thousands of reads
are scored against a handful of exon reference sequences in one wavefront
computation.

Device mapping: the DP recurrence runs as a ``lax.scan`` over QUERY
positions — each step updates a full [n_reads, n_refs, ref_len] score slab
with pure elementwise max/add (no data-dependent control flow), so the whole
batch advances one wavefront per step. Memory is O(batch * ref_len) per
carried row; FLOPs are O(q_len * ref_len * batch) — dense, regular, and
fusable. Linear gap penalties (the classification task needs relative
scores, not optimal affine alignments).

Sequences are integer-encoded on the host (A=0 C=1 G=2 T=3, N/pad=4;
pad never matches).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def encode_seqs(seqs, length: int | None = None) -> np.ndarray:
    """Encode sequences to a padded [n, L] int8 array (pad/N = 4)."""
    if length is None:
        length = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), length), 4, dtype=np.int8)
    for i, s in enumerate(seqs):
        for j, b in enumerate(s[:length].upper()):
            out[i, j] = _CODE.get(b, 4)
    return out


@partial(jax.jit, static_argnames=("match", "mismatch", "gap"))
def sw_scores(queries, refs, match: int = 2, mismatch: int = -1, gap: int = -2):
    """Best local-alignment score of every query against every reference.

    Args:
        queries: [Q, Lq] int8 encoded reads (pad=4).
        refs: [T, Lr] int8 encoded references (pad=4).
        match/mismatch/gap: linear-gap SW scoring.

    Returns scores: [Q, T] int32.
    """
    queries = jnp.asarray(queries)
    refs = jnp.asarray(refs)
    q, lq = queries.shape
    t, lr = refs.shape

    # substitution per (query_pos, ref_pos) is computed on the fly per row
    neg_inf = jnp.int32(-(10**9))

    def step(carry, q_col):
        # carry: (prev_row [Q, T, Lr], best [Q, T])
        prev_row, best = carry
        # q_col: [Q] current query base
        valid_q = (q_col != 4)[:, None, None]
        sub = jnp.where(
            (q_col[:, None, None] == refs[None, :, :]) & (refs[None, :, :] != 4),
            jnp.int32(match),
            jnp.int32(mismatch),
        )
        # H[i, j] = max(0, H[i-1, j-1] + sub, H[i-1, j] + gap, H[i, j-1] + gap)
        diag = jnp.pad(prev_row[:, :, :-1], ((0, 0), (0, 0), (1, 0))) + sub
        up = prev_row + gap

        # Left dependency within the row. With linear gaps the closed form is
        # H[j] = max_{j'<=j} (base[j'] + (j - j') * gap); substituting
        # u[j] = base[j] - j*gap turns it into a plain running max (cummax is
        # associative, unlike the naive "max(b, a+gap)" combiner). The SW
        # zero-clamp is absorbed because base >= 0 dominates any decayed
        # negative chain.
        base = jnp.maximum(jnp.maximum(diag, up), 0)
        base = jnp.where(valid_q, base, jnp.maximum(prev_row, 0))

        decay = (jnp.arange(lr, dtype=jnp.int32) * jnp.int32(-gap))[None, None, :]
        u = jax.lax.associative_scan(jnp.maximum, base + decay, axis=2)
        row = u - decay
        row = jnp.where(valid_q, row, base)
        best = jnp.maximum(best, jnp.max(row, axis=2))
        return (row, best), None

    init = (
        jnp.zeros((q, t, lr), dtype=jnp.int32),
        jnp.zeros((q, t), dtype=jnp.int32),
    )
    (row, best), _ = jax.lax.scan(step, init, queries.T.astype(jnp.int32))
    return best


def sw_score_host(query: str, ref: str, match=2, mismatch=-1, gap=-2) -> int:
    """Tiny O(len^2) host oracle for tests."""
    lq, lr = len(query), len(ref)
    h = np.zeros((lq + 1, lr + 1), dtype=np.int64)
    best = 0
    for i in range(1, lq + 1):
        for j in range(1, lr + 1):
            s = match if query[i - 1].upper() == ref[j - 1].upper() else mismatch
            h[i, j] = max(0, h[i - 1, j - 1] + s, h[i - 1, j] + gap, h[i, j - 1] + gap)
            best = max(best, h[i, j])
    return int(best)


def classify_reads(queries, refs, labels, min_score: int, margin: int = 0,
                   match: int = 2, mismatch: int = -1, gap: int = -2):
    """Assign each read to the best-scoring reference (or none).

    Args:
        queries: [Q, Lq] encoded reads.
        refs: [T, Lr] encoded references.
        labels: T label strings aligned with refs.
        min_score: required best score.
        margin: best must beat second-best by at least this much ("tied"
            reads get label None unless margin == 0).

    Returns: (assigned list[str|None], scores np.ndarray [Q, T]).
    """
    scores = np.asarray(sw_scores(queries, refs, match=match, mismatch=mismatch, gap=gap))
    order = np.argsort(-scores, axis=1)
    best = order[:, 0]
    best_s = scores[np.arange(len(scores)), best]
    second_s = (
        scores[np.arange(len(scores)), order[:, 1]] if scores.shape[1] > 1 else
        np.full(len(scores), -(10**9))
    )
    assigned = []
    for i in range(len(scores)):
        if best_s[i] >= min_score and (best_s[i] - second_s[i]) >= margin:
            assigned.append(labels[best[i]])
        else:
            assigned.append(None)
    return assigned, scores
