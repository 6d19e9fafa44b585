"""Timestamp association for TUM RGB-D streams.

Re-implements the benchmark tool's greedy nearest-timestamp matching
(data/rgbd_dataset/rgbd_benchmark_tools/associate.py:71-101): all pairs
within max_difference sorted by |dt|, greedily matched one-to-one.
"""

from __future__ import annotations


def read_file_list(path):
    """Parse a TUM list file -> {timestamp: [data...]}
    (associate.py:41-68)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.replace(",", " ").split()
            out[float(parts[0])] = parts[1:]
    return out


def associate(first, second, offset=0.0, max_difference=0.02):
    """Greedy one-to-one matching of two {t: data} dicts.

    Returns sorted list of (t1, t2) (associate.py:71-101).
    """
    first_keys = set(first.keys())
    second_keys = set(second.keys())
    potential = sorted(
        (abs(a - (b + offset)), a, b)
        for a in first_keys
        for b in second_keys
        if abs(a - (b + offset)) < max_difference
    )
    matches = []
    for _, a, b in potential:
        if a in first_keys and b in second_keys:
            first_keys.remove(a)
            second_keys.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches
