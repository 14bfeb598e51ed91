"""Refcounted radix (prefix) tree over token sequences owning page-granular
KV cache nodes.

Each node owns a span of *full* pages: ``key`` is a tuple of token ids whose
length is a multiple of the page size, and ``pages`` holds one page id per
``page_size`` tokens of the key.  Children are keyed by the first-page token
chunk of their key, which is sufficient because two children of the same node
must already differ somewhere within their first page (splits happen at page
granularity).

The tree holds exactly one allocator reference per owned page.  ``match``
retains every returned page on behalf of the caller (who must release them),
so a matched prefix can never be evicted or reallocated while a request is
prefilling/decoding against it.  ``insert`` adopts (retains) pages only for
nodes it actually creates and reports the adopted page ids back to the caller
so commit-time bookkeeping (e.g. quantize-on-commit) only touches pages that
are genuinely frozen into the tree.

Eviction is LRU over leaf nodes and never drops a node whose pages have live
outside readers (allocator refcount > 1, i.e. anything beyond the tree's own
reference).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple


class RadixNode:
    __slots__ = ("key", "pages", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], pages: List[int],
                 parent: Optional["RadixNode"]):
        self.key = key          # token span owned by this node (len % ps == 0)
        self.pages = pages      # one page id per page_size tokens of key
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.parent = parent
        self.last_used = 0


class RadixPrefixCache:
    """Page-granular radix tree over token ids, backed by a PageAllocator.

    The allocator only needs three methods: ``retain(ids)``, ``release(ids)``
    and ``refs(page_id)``.
    """

    def __init__(self, allocator, page_size: int):
        self._alloc = allocator
        self.page_size = int(page_size)
        self._root = RadixNode((), [], None)
        self._clock = itertools.count(1)
        # stats
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_tokens = 0
        self.evicted_pages = 0

    # ------------------------------------------------------------------ util
    def _chunk(self, key: Sequence[int]) -> Tuple[int, ...]:
        return tuple(key[: self.page_size])

    def _touch(self, node: RadixNode) -> None:
        t = next(self._clock)
        while node is not None:
            node.last_used = t
            node = node.parent

    @property
    def num_nodes(self) -> int:
        n = 0
        stack = [self._root]
        while stack:
            nd = stack.pop()
            n += 1
            stack.extend(nd.children.values())
        return n - 1  # exclude root

    @property
    def resident_pages(self) -> int:
        return len(self.resident_page_ids())

    def resident_page_ids(self) -> List[int]:
        out: List[int] = []
        stack = [self._root]
        while stack:
            nd = stack.pop()
            out.extend(nd.pages)
            stack.extend(nd.children.values())
        return out

    # ----------------------------------------------------------------- match
    def match(self, tokens: Sequence[int],
              limit: Optional[int] = None) -> Tuple[List[int], int]:
        """Longest page-aligned prefix of ``tokens`` present in the tree.

        Returns ``(pages, n_match)`` where ``pages`` are retained on behalf of
        the caller (caller must release).  The match is capped at
        ``((len(tokens) - 1) // page_size) * page_size`` so the caller always
        has at least one suffix token to prefill (last-token logits); an
        explicit ``limit`` (token count, floored to page alignment) overrides
        that default — callers use it when the suffix-token guarantee comes
        from context beyond ``tokens`` itself.
        """
        ps = self.page_size
        self.lookups += 1
        if limit is None:
            cap = max(0, (len(tokens) - 1) // ps) * ps
        else:
            cap = min(max(0, limit), len(tokens)) // ps * ps
        pages: List[int] = []
        node = self._root
        off = 0
        while off < cap:
            child = node.children.get(self._chunk(tokens[off:]))
            if child is None:
                break
            klen = len(child.key)
            if off + klen > cap or tuple(tokens[off:off + klen]) != child.key:
                # partial match inside this node's span
                n_ok = 0
                limit = min(klen, cap - off)
                for i in range(0, limit, ps):
                    if tuple(tokens[off + i:off + i + ps]) != child.key[i:i + ps]:
                        break
                    n_ok += ps
                if n_ok:
                    pages.extend(child.pages[: n_ok // ps])
                    self._touch(child)
                    off += n_ok
                break
            pages.extend(child.pages)
            off += klen
            node = child
            self._touch(node)
        if pages:
            self._alloc.retain(pages)
            self.hits += 1
            self.hit_tokens += off
        return pages, off

    # ---------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> List[int]:
        """Insert a fully page-aligned token span with its backing pages.

        ``len(tokens)`` must be a multiple of ``page_size`` and ``pages`` must
        hold exactly one page id per page.  Pages belonging to *newly created*
        nodes are retained (adopted) by the tree; page ids already present in
        the tree along this path are ignored.  Returns the list of page ids
        the tree adopted (useful for quantize-on-commit).
        """
        ps = self.page_size
        assert len(tokens) % ps == 0
        assert len(pages) == len(tokens) // ps
        adopted: List[int] = []
        node = self._root
        off = 0
        n = len(tokens)
        while off < n:
            chunk = self._chunk(tokens[off:])
            child = node.children.get(chunk)
            if child is None:
                key = tuple(tokens[off:])
                new_pages = list(pages[off // ps:])
                nd = RadixNode(key, new_pages, node)
                node.children[chunk] = nd
                self._alloc.retain(new_pages)
                adopted.extend(new_pages)
                self.inserted_tokens += len(key)
                self._touch(nd)
                return adopted
            klen = len(child.key)
            # common page-aligned prefix between child.key and tokens[off:]
            n_ok = 0
            limit = min(klen, n - off)
            for i in range(0, limit, ps):
                if tuple(tokens[off + i:off + i + ps]) != child.key[i:i + ps]:
                    break
                n_ok += ps
            if n_ok == klen:
                node = child
                off += klen
                self._touch(node)
                continue
            # split child at n_ok (> 0 since first chunk matched)
            self._split(node, child, n_ok)
            node = node.children[chunk]   # top half of the split
            off += n_ok
            self._touch(node)
        return adopted

    def _split(self, parent: RadixNode, child: RadixNode, at: int) -> None:
        """Split ``child`` so its first ``at`` tokens become a new top node."""
        ps = self.page_size
        top = RadixNode(child.key[:at], child.pages[: at // ps], parent)
        parent.children[self._chunk(child.key)] = top
        child.key = child.key[at:]
        child.pages = child.pages[at // ps:]
        child.parent = top
        top.children[self._chunk(child.key)] = child
        top.last_used = child.last_used

    # ----------------------------------------------------------------- evict
    def evict(self, need_pages: int) -> int:
        """Release up to ``need_pages`` pages by dropping LRU leaf nodes.

        Only drops leaves whose pages all have allocator refcount == 1 (the
        tree's own reference) — a node with live readers is never evicted.
        Returns the number of pages actually released.
        """
        freed = 0
        while freed < need_pages:
            victim = None
            stack = [self._root]
            while stack:
                nd = stack.pop()
                for c in nd.children.values():
                    if c.children:
                        stack.append(c)
                        continue
                    if any(self._alloc.refs(p) != 1 for p in c.pages):
                        continue
                    if victim is None or c.last_used < victim.last_used:
                        victim = c
            if victim is None:
                break
            parent = victim.parent
            del parent.children[self._chunk(victim.key)]
            self._alloc.release(victim.pages)
            freed += len(victim.pages)
            self.evicted_pages += len(victim.pages)
            # collapse chains: if parent became a pass-through with one child
            # we leave it (harmless); but drop empty non-root parents with no
            # pages of their own — cannot happen since every node owns >= 1
            # page, except the root.
        return freed

    def clear(self) -> None:
        """Release every page owned by the tree and reset it."""
        ids = self.resident_page_ids()
        if ids:
            self._alloc.release(ids)
        self._root = RadixNode((), [], None)
