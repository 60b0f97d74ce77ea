"""The host-side page allocator of the paged server (counterpart of
aria_tpu/engine/paged.py:230-301). The paged cache, its writes and the
attention through a page table are ``ops/paged_attention.py``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional


class PagePool:
    """Host-side page allocator (paged.py:230-301): a refcounted free stack
    over the shared pool plus a content-addressed prefix cache.

    Page 0 is reserved as the null page. A page whose count drops to zero
    returns to the free stack unless it was *registered* under a content
    key: then it parks in an LRU, keeping its KV, and ``lookup`` revives it
    when a later prompt shares the prefix. LRU pages are evicted when a
    plain ``alloc`` would otherwise fail, so caching never costs capacity.
    """

    def __init__(self, num_pages: int):
        self.free = list(range(num_pages - 1, 0, -1))  # stack; page 0 reserved
        self.refs: dict = {}  # page -> live reference count
        self.key_to_page: dict = {}  # content key -> registered page
        self.page_to_key: dict = {}
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # registered pages at count 0
        self.hits = 0  # pages served from the prefix cache

    def alloc(self, n: int) -> Optional[list]:
        while len(self.free) < n and self.lru:
            page, _ = self.lru.popitem(last=False)  # evict the least recent
            del self.key_to_page[self.page_to_key.pop(page)]
            self.free.append(page)
        if len(self.free) < n:
            return None
        pages = [self.free.pop() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
        return pages

    def lookup(self, key) -> Optional[int]:
        """Take a reference on the cached page for ``key``, if there is one."""
        page = self.key_to_page.get(key)
        if page is None:
            return None
        self.refs[page] = self.refs.get(page, 0) + 1
        self.lru.pop(page, None)  # referenced again: not evictable
        self.hits += 1
        return page

    def register(self, key, page: int) -> None:
        """Publish a fully written page under a content key; the first
        writer wins."""
        if key in self.key_to_page or page in self.page_to_key:
            return
        self.key_to_page[key] = page
        self.page_to_key[page] = key

    def release(self, pages) -> None:
        for p in pages:
            if p == 0:
                continue
            self.refs[p] = self.refs.get(p, 1) - 1
            if self.refs[p] > 0:
                continue
            del self.refs[p]
            if p in self.page_to_key:
                self.lru[p] = None  # parked with its contents
                self.lru.move_to_end(p)
            else:
                self.free.append(p)

    @property
    def available(self) -> int:
        """Pages allocatable now: free plus evictable cached ones."""
        return len(self.free) + len(self.lru)
