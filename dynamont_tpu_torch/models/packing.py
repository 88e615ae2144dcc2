"""Mixed-length bucket packing for the batched engines.

The reference runs one process per read, so ragged read lengths cost it
nothing (ref: segment.py:292-317). The TPU engines instead launch one
compiled program per padded bucket, and every read in a bucket pays the
bucket's padded length — so HOW reads are grouped decides the padding
waste. Grouping purely by count (round-robin over a sorted list) mixes an
8k read into a 32k bucket and wastes ~a third of the device work on a
realistic length mix.

This module packs a sorted length list into buckets that minimize total
device work, modeled as

    rows(bucket) = ceil(n_reads / group) * t_pad(max_len in bucket)

where `group` is the kernel's read-group size (reads per wavefront row —
sublane packing makes a 5-read group cost exactly what an 8-read group
costs) and `t_pad` is the bucket's padded signal length. An exact interval
DP over the sorted reads finds the optimal grouping in O(n * batch_size):
buckets are contiguous runs of the sorted order, which is optimal for this
cost model (exchanging a longer read out of a bucket never helps).

Shape discipline: padded lengths come from a RELATIVE ladder (quantum
~T/8, floored at `t_pad_to`) and bucket read-counts are padded up to a
multiple of `group` — so the set of compiled (R, T_pad) shapes stays
small and re-runs hit the jit/persistent cache.
"""

from __future__ import annotations


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def t_pad_ladder(T: int, t_pad_to: int = 512) -> int:
    """Padded length for a true (sample count + 1) length T: relative
    quantum of ~T/8 (power of two), floored at t_pad_to. Bounded shapes:
    at most 8 pad points per octave of read length."""
    q = max(t_pad_to, 1 << max(0, T.bit_length() - 4))
    return round_up(T, q)


def pack_buckets(
    lengths: list[int],
    batch_size: int,
    max_batch_samples: int,
    t_pad_to: int = 512,
    group: int = 8,
    launch_overhead_rows: int = 512,
) -> list[list[int]]:
    """Pack reads (by signal length) into buckets minimizing device rows.

    Returns a list of buckets, each a list of indices into `lengths`,
    ordered short-to-long. `group` is the kernel read-group size (G);
    `launch_overhead_rows` is the fixed per-launch cost in row units and
    breaks ties toward fewer launches.
    """
    n = len(lengths)
    if n == 0:
        return []
    order = sorted(range(n), key=lambda i: lengths[i])
    # t_pad of each read if it were the longest in its bucket
    pads = [t_pad_ladder(lengths[i] + 1, t_pad_to) for i in order]

    INF = float("inf")
    dp = [INF] * (n + 1)
    cut = [0] * (n + 1)
    dp[0] = 0.0
    for i in range(1, n + 1):
        t_pad = pads[i - 1]  # sorted: last read in bucket is the longest
        for j in range(max(0, i - batch_size), i):
            cnt = i - j
            rp = round_up(cnt, group)
            if rp * t_pad > max_batch_samples and cnt > 1:
                continue
            rows = (rp // group) * t_pad + launch_overhead_rows
            cand = dp[j] + rows
            if cand < dp[i]:
                dp[i] = cand
                cut[i] = j
    buckets: list[list[int]] = []
    i = n
    while i > 0:
        j = cut[i]
        buckets.append(order[j:i])
        i = j
    buckets.reverse()
    return buckets


def pad_reads_to(count: int, group: int) -> int:
    """Wire read-axis padding: the kernels round the read axis up to the
    group size internally, so padding the wire to the same multiple costs
    zero extra device work and collapses the compiled-shape set."""
    return round_up(count, group)
