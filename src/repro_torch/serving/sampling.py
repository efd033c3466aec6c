"""On-device sampling: temperature + top-k, keyed per request.

Counterpart of the JAX package's ``serving/sampling.py``.  The sampler
reads three small per-slot registers (temperature, top-k, seed) that the
host writes once at admission, like ``budget`` and ``out_count``, and
adds no device-to-host transfer to the step.

Determinism contract: the noise for a slot's i-th output token is a pure
function of ``(seed, i)`` -- ``fold_in(fold_in(key0, seed), i)`` --
never of the slot index or the step number.  So the same request
replayed on any slot, in any batch, at any chunk size draws the same
tokens; a request preempted after k tokens resumes at ``out_count == k``
and draws token k + 1 from the key it would have used unpreempted; and a
speculative lane (:func:`sample_lane`) scores position i with key
``out_count + i``, so acceptance and rollback consume key indices in
order.  Recovery after a crash replays the same way.

The noise is JAX's: a copy of ``jax.random``'s threefry2x32 in the
partitionable mode (``jax_threefry_partitionable`` on, the default of
jax 0.9), its ``fold_in``, its 32-bit random bits, its ``uniform`` on
``[tiny, 1)`` and the float32 Gumbel ``-log(-log(u))``.  The bits and
the uniforms equal ``jax.random``'s bit for bit; the Gumbel floats may
differ from XLA's in the last place, where the two ``log``s differ.
torch has no usable uint32 arithmetic, so the hash runs on int64
tensors masked to 32 bits after every add and rotate.

``temperature <= 0`` is plain argmax, the greedy engine's token.
"""

from __future__ import annotations

import torch

I32 = torch.int32
_M32 = 0xFFFFFFFF
#: threefry2x32's rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: float32's smallest normal number: the uniforms' lower bound
_TINY = torch.finfo(torch.float32).tiny


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor as its uint32 value, held in int64 (an int32
    wraps as JAX's ``uint32`` conversion does)."""
    return x.to(torch.int64) & _M32


def threefry2x32(k1, k2, x0, x1):
    """The threefry2x32 hash of counts ``(x0, x1)`` under key ``(k1,
    k2)``: 20 rounds, a key injection after every four.  Every argument
    is a uint32 value in an int64 tensor (or a Python int); they
    broadcast.  Returns the two uint32 output words, in int64."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(k1, k2, data):
    """``jax.random.fold_in`` of the key ``(k1, k2)`` with uint32
    ``data``: the hash of the count pair ``(0, data)``."""
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def request_key(seeds: torch.Tensor, counts: torch.Tensor):
    """The key of each (seed, output position): ``fold_in(fold_in(
    PRNGKey(0), seed), count)``, PRNGKey(0) being the zero key.  int32
    seeds and counts of one shape; returns two uint32 words of that
    shape, in int64."""
    s, c = _u32(seeds), _u32(counts)
    k1, k2 = fold_in(torch.zeros_like(s), torch.zeros_like(s), s)
    return fold_in(k1, k2, c)


def random_bits(k1, k2, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` in the partitionable mode
    for each key: the hash of the counts (0, i) for i < n, its two words
    XORed.  Keys ``[...]`` -> bits ``[..., n]`` (uint32 values in
    int64)."""
    iota = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(iota), iota)
    return b1 ^ b2


def uniform(k1, k2, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``
    for each key: the top 23 bits as the mantissa of a float in [1, 2),
    less one, scaled into [tiny, 1)."""
    bits = random_bits(k1, k2, n)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(I32).view(torch.float32) - 1.0
    # (1 - tiny) rounds to 1 and tiny is exact in float32, as in JAX;
    # Python scalars, so no host-to-device copy
    return (floats * (1.0 - _TINY) + _TINY).clamp(min=_TINY)


def gumbel(seeds: torch.Tensor, counts: torch.Tensor, n: int
           ) -> torch.Tensor:
    """The float32 Gumbel noise of each (seed, output position) over
    ``n`` vocabulary columns: ``jax.random.gumbel(key, (n,))`` in its
    default ("low") mode.  ``[...]`` -> ``[..., n]``."""
    k1, k2 = request_key(seeds, counts)
    return -torch.log(-torch.log(uniform(k1, k2, n)))


def perturbed_scores(logits: torch.Tensor, temp: torch.Tensor,
                     top_k: torch.Tensor, seeds: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """``logits / T + g`` after the top-k mask, in float32: the scores
    whose argmax is a sampled token (Gumbel-max: argmax(logits/T + g) ~
    softmax(logits/T)).  ``logits [..., V]``; the registers ``[...]``.

    Top-k keeps the logits at or above the k-th largest of the slot's
    row, from one sort and a gather (no host read of k): k = 0, or k >=
    V, keeps every column."""
    logits = logits.float()
    V = logits.shape[-1]
    k = top_k.clamp(1, V)
    srt = logits.sort(-1).values                      # ascending
    kth = srt.gather(-1, (V - k).long()[..., None])
    cut = (top_k > 0)[..., None] & (logits < kth)
    masked = logits.masked_fill(cut, float("-inf"))
    t = temp.float().clamp(min=1e-6)[..., None]
    return masked / t + gumbel(seeds, counts, V)


def sample_tokens(logits: torch.Tensor, temp: torch.Tensor,
                  top_k: torch.Tensor, seeds: torch.Tensor,
                  counts: torch.Tensor) -> torch.Tensor:
    """Sample one token per slot from ``[DP, Bl, V]`` logits.

    temp: float32[DP, Bl] (<= 0: greedy argmax for that slot); top_k:
    int32[DP, Bl] (0: the whole vocabulary); seeds: int32[DP, Bl]
    per-request seeds; counts: int32[DP, Bl] tokens emitted so far (the
    fold-in position).  Returns int32[DP, Bl].  Fixed shapes, no host
    sync; the leading axes may be any.
    """
    greedy = logits.float().argmax(-1).to(I32)
    scores = perturbed_scores(logits, temp, top_k, seeds, counts)
    return torch.where(temp > 0, scores.argmax(-1).to(I32), greedy)


def sample_lane(logits: torch.Tensor, temp: torch.Tensor,
                top_k: torch.Tensor, seeds: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
    """Sample one token per lane position from ``[DP, Bl, T, V]``
    logits: position i of a slot's lane draws with key ``fold_in(
    fold_in(key0, seed), counts[..., i])``, the caller passing
    ``out_count + i`` on a draft/verify lane and ``out_count`` on a
    prompt lane (whose one emitting position is output index 0).  The
    registers are ``[DP, Bl]``, counts ``[DP, Bl, T]``; returns
    int32[DP, Bl, T]."""
    T = logits.shape[2]

    def lane(r):
        return r[:, :, None].expand(-1, -1, T)

    return sample_tokens(logits, lane(temp), lane(top_k), lane(seeds),
                         counts)
