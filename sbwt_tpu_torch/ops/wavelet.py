"""Balanced wavelet tree over a small alphabet (sigma <= 5), generic over
the bit-vector class.

The port of sbwt_tpu/ops/wavelet.py: the alphabet is split in halves
recursively, and all nodes of one depth are concatenated into one level
bit vector, so ``rank(sym, pos)`` is one bit-vector rank per level.
``rank`` and ``rank_pair`` here are the plain PyTorch versions of the
device type in csrc/wavelet.cuh (K16).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import kernels
from .bv import BV_CLASSES

MAX_SIGMA = 5
MAX_DEPTH = 3


def _build_shape(lo: int, hi: int, depth: int, nodes: list) -> int | None:
    if hi - lo <= 1:
        return None
    mid = (lo + hi + 1) // 2
    nid = len(nodes)
    nodes.append({"lo": lo, "mid": mid, "hi": hi, "depth": depth})
    nodes[nid]["left"] = _build_shape(lo, mid, depth + 1, nodes)
    nodes[nid]["right"] = _build_shape(mid, hi, depth + 1, nodes)
    return nid


def _symbol_paths(sigma: int, nodes: list, root: int | None, D: int):
    """Per-symbol descent paths [sigma, D]: node id, go-right bit, valid."""
    path_node = np.zeros((sigma, D), dtype=np.int32)
    path_bit = np.zeros((sigma, D), dtype=np.int32)
    path_valid = np.zeros((sigma, D), dtype=bool)
    for s in range(sigma):
        nid, d = root, 0
        while nid is not None:
            right = s >= nodes[nid]["mid"]
            path_node[s, d], path_bit[s, d], path_valid[s, d] = nid, int(right), True
            nid = nodes[nid]["right"] if right else nodes[nid]["left"]
            d += 1
    return path_node, path_bit, path_valid


def _depth(sigma: int) -> int:
    return max(1, int(np.ceil(np.log2(max(2, sigma)))))


class WaveletTree(nn.Module):
    """levels: one bit vector per depth; node_base / node_rank int32
    [n_nodes]: a node's bit offset in its level and the ones before it;
    path tables int32 [sigma, D] (node id, go-right bit, valid)."""

    def __init__(self, levels, node_base: np.ndarray, node_rank: np.ndarray, *,
                 sigma: int, n: int, bv_kind: str):
        super().__init__()
        if not 2 <= sigma <= MAX_SIGMA:
            raise ValueError(f"wavelet tree alphabet {sigma} outside 2..{MAX_SIGMA}")
        self.levels = nn.ModuleList(levels)
        self.sigma, self.n, self.depth, self.bv_kind = int(sigma), int(n), _depth(sigma), bv_kind
        nodes: list = []
        root = _build_shape(0, sigma, 0, nodes)
        pn, pb, pv = _symbol_paths(sigma, nodes, root, self.depth)
        self._host = (np.asarray(node_base, np.int32), np.asarray(node_rank, np.int32), pn, pb, pv)
        dev = next(levels[0].buffers()).device
        for name, a in zip(("node_base", "node_rank", "path_node", "path_bit", "path_valid"),
                           self._host):
            self.register_buffer(name, torch.as_tensor(a.astype(np.int64), device=dev))

    @classmethod
    def build(cls, symbols: np.ndarray, sigma: int, bv_kind: str = "plain",
              device="cpu") -> "WaveletTree":
        symbols = np.asarray(symbols, dtype=np.int64)
        nodes: list = []
        root = _build_shape(0, sigma, 0, nodes)
        node_bools = {}
        seqs = {root: symbols}
        for nid, node in enumerate(nodes):
            seq = seqs.pop(nid, np.empty(0, dtype=np.int64))
            right = seq >= node["mid"]
            node_bools[nid] = right
            if node["left"] is not None:
                seqs[node["left"]] = seq[~right]
            if node["right"] is not None:
                seqs[node["right"]] = seq[right]
        node_base = np.zeros(len(nodes), dtype=np.int32)
        node_rank = np.zeros(len(nodes), dtype=np.int32)
        levels = []
        for d in range(_depth(sigma)):
            parts, off, ones = [], 0, 0
            for nid in (i for i, nd in enumerate(nodes) if nd["depth"] == d):
                b = node_bools[nid]
                node_base[nid], node_rank[nid] = off, ones
                ones += int(b.sum())
                off += len(b)
                parts.append(b)
            bits = np.concatenate(parts) if parts else np.zeros(0, dtype=bool)
            levels.append(BV_CLASSES[bv_kind].build(bits, device))
        return cls(levels, node_base, node_rank, sigma=sigma, n=len(symbols), bv_kind=bv_kind)

    def rank(self, sym, pos):
        """Count of sym in positions [0, pos); lanes may differ in symbol; int64."""
        sym, pos = torch.broadcast_tensors(torch.as_tensor(sym, device=self.node_base.device).long(),
                                           torch.as_tensor(pos, device=self.node_base.device).long())
        for d in range(self.depth):
            nid = self.path_node[sym, d]
            valid = self.path_valid[sym, d] == 1
            # a symbol whose path ended reads position 0, which is in bounds
            r1 = self.levels[d].rank(torch.where(valid, self.node_base[nid] + pos, 0))
            r1 = r1 - self.node_rank[nid]
            nxt = torch.where(self.path_bit[sym, d] == 1, r1, pos - r1)
            pos = torch.where(valid, nxt, pos)
        return pos

    def rank_pair(self, sym, pos):
        """(rank(sym, pos), rank(sym, pos + 1)) at the cost of one rank:
        the two positions stay equal or adjacent (q in {p, p + 1}) down the
        tree, so each level's rank_pair answers both."""
        sym, pos = torch.broadcast_tensors(torch.as_tensor(sym, device=self.node_base.device).long(),
                                           torch.as_tensor(pos, device=self.node_base.device).long())
        p, q = pos, pos + 1
        for d in range(self.depth):
            nid = self.path_node[sym, d]
            brank = self.node_rank[nid]
            valid = self.path_valid[sym, d] == 1
            ra, rb = self.levels[d].rank_pair(torch.where(valid, self.node_base[nid] + p, 0))
            rp = ra - brank
            rq = torch.where(q == p, ra, rb) - brank
            right = self.path_bit[sym, d] == 1
            p, q = (torch.where(valid, torch.where(right, rp, p - rp), p),
                    torch.where(valid, torch.where(right, rq, q - rq), q))
        return p, q

    def to_symbols(self) -> np.ndarray:
        nodes: list = []
        root = _build_shape(0, self.sigma, 0, nodes)
        level_bools = [bv.to_bools() for bv in self.levels]
        node_base = self._host[0]

        def decode(nid, count):
            node = nodes[nid]
            bits = level_bools[node["depth"]][node_base[nid] : node_base[nid] + count]
            out = np.empty(count, dtype=np.int64)
            nL, nR = int((~bits).sum()), int(bits.sum())
            out[~bits] = (np.full(nL, node["lo"], dtype=np.int64) if node["left"] is None
                          else decode(node["left"], nL))
            out[bits] = (np.full(nR, node["mid"], dtype=np.int64) if node["right"] is None
                         else decode(node["right"], nR))
            return out

        return decode(root, self.n)

    def payload(self) -> dict:
        out = {"sigma": np.int64(self.sigma), "n": np.int64(self.n)}
        for i, bv in enumerate(self.levels):
            for k, v in bv.payload().items():
                out[f"lvl{i}_{k}"] = v
        return out

    @classmethod
    def from_payload(cls, p: dict, bv_kind: str, device="cpu") -> "WaveletTree":
        sigma, n = int(p["sigma"]), int(p["n"])
        D = _depth(sigma)
        levels = []
        for i in range(D):
            prefix = f"lvl{i}_"
            sub = {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}
            levels.append(BV_CLASSES[bv_kind].from_payload(sub, device))
        # node_base / node_rank from the decoded level bits
        nodes: list = []
        root = _build_shape(0, sigma, 0, nodes)
        node_base = np.zeros(len(nodes), dtype=np.int32)
        node_rank = np.zeros(len(nodes), dtype=np.int32)
        level_bools = [bv.to_bools() for bv in levels]
        counts = {root: n}
        for d in range(D):
            off = rank_off = 0
            for nid in (i for i, nd in enumerate(nodes) if nd["depth"] == d):
                cnt = counts.get(nid, 0)
                node_base[nid], node_rank[nid] = off, rank_off
                nR = int(level_bools[d][off : off + cnt].sum())
                if nodes[nid]["left"] is not None:
                    counts[nodes[nid]["left"]] = cnt - nR
                if nodes[nid]["right"] is not None:
                    counts[nodes[nid]["right"]] = nR
                off += cnt
                rank_off += nR
        return cls(levels, node_base, node_rank, sigma=sigma, n=n, bv_kind=bv_kind)

    def size_in_bytes(self) -> int:
        return sum(bv.size_in_bytes() for bv in self.levels)

    def steps(self) -> np.ndarray:
        """int32 [MAX_SIGMA, MAX_DEPTH, 4]: (node base, node rank, go-right
        bit, valid) of each symbol's node at each depth; zeros elsewhere."""
        node_base, node_rank, pn, pb, pv = self._host
        out = np.zeros((MAX_SIGMA, MAX_DEPTH, 4), dtype=np.int32)
        for s in range(self.sigma):
            for d in range(self.depth):
                if pv[s, d]:
                    nid = pn[s, d]
                    out[s, d] = (node_base[nid], node_rank[nid], pb[s, d], 1)
        return out

    def desc(self, dev):
        kind = self.bv_kind
        levels = [bv.desc(dev) for bv in self.levels]
        levels += [kernels.BV_DESCS[kind]()] * (MAX_DEPTH - len(levels))
        return kernels.WT_DESCS[kind]((kernels.BV_DESCS[kind] * MAX_DEPTH)(*levels),
                                      kernels.c_ints(self.steps().ravel()), self.depth)
