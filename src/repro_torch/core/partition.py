"""Size-bounded bucket -> segment partitioning (paper §III.C, Alg 1 L7-11).

Buckets (grouped by LSH code) are walked in code order; undersized
buckets are merged with *adjacent* buckets (adjacent integer codes share
long sign-prefixes => small Hamming distance), oversized runs are split
into even contiguous parts.  All functions are pure and deterministic:
items are (key, item_id) pairs, ordering is (key, item_id).

Invariants (property-tested in tests/test_partition.py):

- one-to-one: every item appears in exactly one output segment;
- hard upper bound: every segment has size <= s_max, always;
- lower bound: every segment has size >= s_min whenever feasible
  (infeasible only if (a) the whole input run has < s_min items, or
  (b) no integer p satisfies n/p in [s_min, s_max] for the run --
  e.g. n=13 cannot be split into parts within [10, 12]);
- order preservation: concatenating segments reproduces the sorted
  input order (segments own contiguous key ranges -> incremental
  updates stay local).
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

Item = Tuple[int, str]  # (code key, item id)


def sort_items(items: Iterable[Item]) -> List[Item]:
    return sorted(items, key=lambda t: (t[0], t[1]))


def group_buckets(items: Sequence[Item]) -> List[List[Item]]:
    """Sorted items -> buckets of equal code key."""
    buckets: List[List[Item]] = []
    for it in sort_items(items):
        if buckets and buckets[-1][0][0] == it[0]:
            buckets[-1].append(it)
        else:
            buckets.append([it])
    return buckets


def choose_parts(n: int, s_min: int, s_max: int) -> int:
    """Number of even parts for a run of n items.

    Picks the smallest p with all parts <= s_max (fewest segments =>
    fewest LLM summaries, the dominant cost); if that p makes parts
    < s_min and a feasible p exists in [ceil(n/s_max), floor(n/s_min)],
    feasibility is already guaranteed by p = ceil(n/s_max) whenever the
    interval is non-empty, since ceil(n/s_max) is its left endpoint.
    """
    if n <= s_max:
        return 1
    return -(-n // s_max)  # ceil


def split_even(run: Sequence[Item], p: int) -> List[List[Item]]:
    """Split into p contiguous parts, sizes differing by at most 1."""
    n = len(run)
    base, rem = divmod(n, p)
    out: List[List[Item]] = []
    start = 0
    for i in range(p):
        size = base + (1 if i < rem else 0)
        out.append(list(run[start:start + size]))
        start += size
    assert start == n
    return out


def make_runs(buckets: Sequence[Sequence[Item]], s_min: int
              ) -> List[List[Item]]:
    """Greedy adjacent merge: accumulate buckets until run >= s_min.

    A trailing run smaller than s_min is folded into its predecessor
    (paper: merge with adjacent until >= S_min).
    """
    runs: List[List[Item]] = []
    cur: List[Item] = []
    for b in buckets:
        cur.extend(b)
        if len(cur) >= s_min:
            runs.append(cur)
            cur = []
    if cur:
        if runs:
            runs[-1].extend(cur)
        else:
            runs.append(cur)  # whole input < s_min: single small run
    return runs


def partition_items(items: Iterable[Item], s_min: int, s_max: int
                    ) -> List[List[Item]]:
    """Full pipeline: sort -> bucket -> merge runs -> even split."""
    if s_min < 1 or s_max < s_min:
        raise ValueError(f"invalid bounds [{s_min}, {s_max}]")
    buckets = group_buckets(list(items))
    if not buckets:
        return []
    segments: List[List[Item]] = []
    for run in make_runs(buckets, s_min):
        p = choose_parts(len(run), s_min, s_max)
        segments.extend(split_even(run, p))
    return segments


def segments_contiguous(segments: Sequence[Sequence[Item]]) -> bool:
    """True iff concatenated segments are globally sorted (audit)."""
    flat = [it for seg in segments for it in seg]
    return flat == sort_items(flat)
