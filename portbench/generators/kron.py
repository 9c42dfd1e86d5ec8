"""The GAP suite's ``kron`` graph: the Graph500 Kronecker generator
(``2**scale`` vertices, ``edgefactor * 2**scale`` edges; at each of
``scale`` levels one uniform draw picks the quadrant by ``a``, ``b``,
``c``), vertex labels permuted at random, then built undirected with
self-loops and duplicate edges removed, as GAP builds its graphs. The edges
come from the configuration's fixed ``graph_seed``, as GAP's generator
draws from a fixed seed, so every run holds the same graph; the labels
are permuted from the run's seed. Everything is drawn on ``device``; the
result is the adjacency pattern as CSR with each row's columns ascending,
and ``labels``: the label of each generated vertex."""

from __future__ import annotations

import torch

# edges drawn in one call at most: bounds the generator's temporaries
_CHUNK = 1 << 26


def generate(cfg: dict, seed: int, device) -> dict:
    scale, ef = int(cfg["scale"]), int(cfg["edgefactor"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    n, m = 1 << scale, ef << scale
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["graph_seed"]))
    keys = []
    for lo in range(0, m, _CHUNK):
        e = min(_CHUNK, m - lo)
        src = torch.zeros(e, dtype=torch.int64, device=device)
        dst = torch.zeros(e, dtype=torch.int64, device=device)
        for _ in range(scale):
            r = torch.rand(e, generator=gen, device=device)
            src = 2 * src + (r >= a + b)
            dst = 2 * dst + (((r > a) & (r < a + b)) | (r > a + b + c))
        keys.append((src, dst))
    gen.manual_seed(int(seed))
    perm = torch.randperm(n, generator=gen, device=device)
    parts = []
    for src, dst in keys:
        src, dst = perm[src], perm[dst]
        keep = src != dst                              # no self-loops
        src, dst = src[keep], dst[keep]
        parts += [src * n + dst, dst * n + src]        # undirected
    del keys
    key = torch.unique(torch.cat(parts))               # sorted, no duplicates
    del parts
    indices = (key % n).to(torch.int32)
    counts = torch.bincount(key // n, minlength=n)
    del key
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(counts, dim=0)
    return {"shape": (n, n), "indptr": indptr.to(torch.int32),
            "indices": indices, "data": None, "labels": perm}
