"""Host-side page bookkeeping for the paged KV cache (DESIGN.md §3.8).

A verbatim copy of ``repro/serving/paging.py``, which is framework-free.

Two pieces, both pure numpy/python (no JAX): the device side of the paged cache
is just two arrays per layer (a page pool and a page table — models/model.py::
init_cache(layout="paged")), so all allocation policy lives here where it is
cheap to test exhaustively.

* :class:`PagePool` — a ref-counted free-list allocator over ``n_pages`` physical
  pages. A page is held by every active sequence whose page table references it
  plus (optionally) the radix index retaining it as a cached prefix; it returns
  to the free list when the last reference drops.

* :class:`RadixIndex` — a radix tree over *page-sized token chunks*: node =
  one full page of prompt tokens, child edges keyed by the exact chunk content.
  Admission walks the tree to find the longest previously-prefilled prefix;
  matched pages are mapped into the new request's page table **copy-free** (the
  pool just increfs). A partially matching tail chunk is reported separately so
  the engine can copy-on-write the first ``j`` token rows into a fresh page
  instead of re-prefilling them. Retained prefixes are evicted LRU-leaf-first
  under pool pressure.

Why sharing is exact (not approximate): CrossQuant / per-token KV quantization
is deterministic — identical prefix tokens produce identical K/V, hence
bit-identical int8 codes and scale rows — so a shared page is byte-for-byte the
page a cold prefill would have written (DESIGN.md §3.8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PagePool:
    """Ref-counted allocator over ``n_pages`` physical KV pages.

    ``refs[p] == 0``  ⇔  page ``p`` is on the free list. Sequences and the radix
    index each hold one reference per page they retain.
    """

    def __init__(self, n_pages: int):
        assert n_pages > 0
        self.n_pages = n_pages
        self.refs = np.zeros(n_pages, np.int32)
        # stack: pop() hands out low page ids first (easier to read in tests)
        self._free: List[int] = list(range(n_pages - 1, -1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages with refcount 1, or None if the pool can't cover it
        (caller decides whether to evict cached prefixes and retry)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.refs[pages] = 1
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert self.refs[p] > 0, f"incref on free page {p}"
            self.refs[p] += 1

    def decref(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; pages reaching zero return to the free
        list (returned for the caller's stats)."""
        freed = []
        for p in pages:
            assert self.refs[p] > 0, f"decref on free page {p}"
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def check(self) -> None:
        """Invariants (tests): free list and refcounts partition the pool."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages on the free list"
        for p in range(self.n_pages):
            if p in free:
                assert self.refs[p] == 0, f"page {p} free with refs {self.refs[p]}"
            else:
                assert self.refs[p] > 0, f"page {p} leaked (refs 0, not free)"


@dataclasses.dataclass
class _Node:
    chunk: bytes                       # the page's token content (ps int32 tokens)
    page: int                          # physical page id holding this chunk's KV
    parent: Optional["_Node"]
    children: Dict[bytes, "_Node"] = dataclasses.field(default_factory=dict)
    touch: int = 0                     # LRU clock at last match/insert


@dataclasses.dataclass
class PartialHit:
    """The tail chunk of a match that extends ``tokens`` only partially: the
    first ``length`` token rows of cached page ``page`` can be copy-on-write'd
    into a fresh page instead of re-prefilled."""
    page: int
    length: int


class RadixIndex:
    """Radix tree over page-sized prompt chunks (see module docstring)."""

    def __init__(self, page_size: int):
        self.ps = page_size
        self._root = _Node(chunk=b"", page=-1, parent=None)
        self._clock = 0
        self.n_nodes = 0

    # ------------------------------------------------------------------ match

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens: np.ndarray) -> Tuple[List[int], int, Optional[PartialHit]]:
        """Longest cached prefix of ``tokens`` at full-page granularity.

        Returns ``(pages, matched_tokens, partial)``: the physical pages of every
        fully matched chunk (``matched_tokens == len(pages) * page_size``), plus
        an optional :class:`PartialHit` when some child chunk of the deepest node
        shares a further proper prefix with the remaining tokens. Matched nodes
        are LRU-touched. The caller caps the usable prefix (a request must keep
        at least one suffix token to prefill).
        """
        tokens = np.asarray(tokens, np.int32)
        node, pages, off = self._root, [], 0
        now = self._tick()
        while off + self.ps <= len(tokens):
            child = node.children.get(tokens[off: off + self.ps].tobytes())
            if child is None:
                break
            child.touch = now
            pages.append(child.page)
            node, off = child, off + self.ps
        partial = None
        rest = tokens[off:]
        if len(rest) > 0:
            best = 0
            for child in node.children.values():
                chunk = np.frombuffer(child.chunk, np.int32)
                n = min(len(rest), len(chunk))
                eq = chunk[:n] == rest[:n]
                lcp = int(n if eq.all() else int(np.argmin(eq)))
                if 0 < lcp < self.ps and lcp > best:
                    best = lcp
                    partial = PartialHit(page=child.page, length=lcp)
                    child.touch = now
        return pages, off, partial

    # ----------------------------------------------------------------- insert

    def insert(self, tokens: np.ndarray, pages: Sequence[int], pool: PagePool) -> int:
        """Register every full-page chunk of ``tokens`` along one root path.

        ``pages[k]`` is the physical page holding chunk ``k``'s KV. Chunks
        already present keep their existing page (the new request mapped it
        copy-free anyway); new nodes take one pool reference — the index's own
        retain — released on eviction. Returns the number of nodes created.
        """
        tokens = np.asarray(tokens, np.int32)
        node, created, now = self._root, 0, self._tick()
        for k in range(min(len(tokens) // self.ps, len(pages))):
            key = tokens[k * self.ps: (k + 1) * self.ps].tobytes()
            child = node.children.get(key)
            if child is None:
                child = _Node(chunk=key, page=pages[k], parent=node)
                node.children[key] = child
                pool.incref([pages[k]])
                self.n_nodes += 1
                created += 1
            child.touch = now
            node = child
        return created

    # ------------------------------------------------------------------ evict

    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict(self, pool: PagePool, n_needed: int) -> int:
        """Drop LRU cached prefixes until ``n_needed`` pages are free (or no
        evictable node remains). Only *unreferenced* prefixes are evictable: a
        leaf whose page is held solely by the index (``refs == 1``). Evicting a
        leaf may expose its parent; the scan repeats until dry. Returns the
        number of pages actually freed."""
        freed = 0
        while pool.free_count < n_needed:
            cands = [n for n in self._leaves() if pool.refs[n.page] == 1]
            if not cands:
                break
            victim = min(cands, key=lambda n: n.touch)
            del victim.parent.children[victim.chunk]
            self.n_nodes -= 1
            freed += len(pool.decref([victim.page]))
        return freed

    def held_pages(self) -> List[int]:
        """Every page currently retained by the index (tests/invariants)."""
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(n.children.values())
        return out
