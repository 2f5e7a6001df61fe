"""Host-side radix-tree prefix index for shared-prefix KV reuse (DESIGN.md
§10).

Agentic traffic is dominated by shared system prompts, repeated tool
schemas, and multi-turn histories; re-prefilling the common prefix per flow
is the single biggest avoidable cost at serving scale.  ``PrefixCache``
indexes *token-ID sequences* (the exactness currency of this repo — a hit
is valid iff the tokens match exactly) in a radix tree: shared prefixes are
stored once, edges split lazily on divergence, and the deepest indexed node
covering a match is the handle through which the real backend resolves a
physical KV source (a donor pool row, or a refcounted off-pool snapshot —
see ``JaxRealBackend``).

This module is deliberately **pure host logic with no JAX import** so the
simulation-only path stays JAX-free: ``SimBackend`` drives the same index
with the same call sequence (match at arrival, insert at prefill
completion, pin while a consumer is in flight), which is what keeps
sim/real traces equal with the cache on or off.  All tie-breaking is by a
logical tick counter + node id, never wall-clock, so eviction order is a
pure function of the operation sequence.

Capacity is counted in *indexed tokens* (radix storage: each token of each
edge counted once, shared prefixes deduplicated).  Eviction is LRU over
evictable leaves only — a node with children backs shorter prefixes of a
longer donor and is only reachable once its subtree drains; a node with
``refs > 0`` is pinned by an in-flight consumer and never evicted.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

DEFAULT_CAPACITY_TOKENS = 1 << 16


def prefix_reuse_supported(cfg, max_len: int) -> bool:
    """Static gate: prefix KV copies are exact only when every layer's ring
    state at position ``p`` is a pure function of tokens ``[0, p)`` and the
    ring never wraps below ``max_len``:

    * recurrent / conv layers (rwkv6, rglru, mamba …) fold the whole prefix
      into a dense state that cannot be truncated at the hit boundary;
    * a sliding-window ring (``alloc < max_len``) overwrites early
      positions, so a donor row need not still hold ``[0, hit)``;
    * enc-dec cross-attention state depends on the *request's* encoder
      input, which a copied prefix would alias (see ``reset_row``).
    """
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        return False
    if any(k != "attn" for k in cfg.layer_kinds):
        return False
    if cfg.sliding_window is not None and cfg.sliding_window < max_len:
        return False
    return True


class PrefixNode:
    """One radix edge: ``key`` extends the parent's path; ``depth`` is the
    total token count root → end of this edge.  ``source`` is an opaque
    physical-KV handle owned by the consuming backend (``None`` in sim)."""

    __slots__ = ("key", "children", "parent", "depth", "refs", "tick",
                 "source", "nid")

    def __init__(self, key: Tuple[int, ...], parent: Optional["PrefixNode"],
                 depth: int, tick: int, nid: int):
        self.key = key
        self.children: dict = {}
        self.parent = parent
        self.depth = depth
        self.refs = 0
        self.tick = tick
        self.source = None
        self.nid = nid


class PrefixCache:
    """Radix prefix index with logical-LRU leaf eviction.

    ``block`` rounds every reported hit down to a multiple (block-granular
    donor tracking: hits address whole KV blocks, which also bounds the
    pow-2 jit-key churn of the copy programs downstream)."""

    def __init__(self, capacity_tokens: int = DEFAULT_CAPACITY_TOKENS,
                 block: int = 1):
        self.capacity_tokens = max(int(capacity_tokens), 1)
        self.block = max(int(block), 1)
        self._tick = 0
        self._next_id = 0
        self.root = self._mk((), None, 0)
        self.size_tokens = 0
        # stats (reported through backend.stats())
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserts = 0
        self.splits = 0
        self.evictions = 0
        self.evicted_tokens = 0

    def _mk(self, key, parent, depth) -> PrefixNode:
        n = PrefixNode(tuple(key), parent, depth, self._tick, self._next_id)
        self._next_id += 1
        return n

    # -- lookup ---------------------------------------------------------------
    def match(self, tokens: Sequence[int],
              max_hit: Optional[int] = None
              ) -> Tuple[int, Optional[PrefixNode]]:
        """Longest indexed prefix of ``tokens``.

        Returns ``(hit, node)`` where ``node`` is the deepest node whose
        edge contains the match end — its donor holds KV for ``[0,
        node.depth) ⊇ [0, hit)``, so any capped/rounded hit stays servable
        from it.  A partial-edge match counts (the donor stored the whole
        edge).  Touches the matched path's LRU ticks.  ``max_hit`` caps the
        hit (callers pass ``prompt_len - 1``: at least one real forward
        must run to produce the first output token)."""
        self._tick += 1
        node, i, last = self.root, 0, None
        n = len(tokens)
        while i < n:
            child = node.children.get(tokens[i])
            if child is None:
                break
            k = child.key
            j, m = 0, min(len(k), n - i)
            while j < m and k[j] == tokens[i + j]:
                j += 1
            if j == 0:
                break
            i += j
            child.tick = self._tick
            last = node = child
            if j < len(k):
                break  # diverged (or ran out of query) mid-edge
        hit = i
        if max_hit is not None:
            hit = min(hit, max_hit)
        hit -= hit % self.block
        if hit <= 0 or last is None:
            self.misses += 1
            return 0, None
        self.hits += 1
        self.hit_tokens += hit
        return hit, last

    # -- pinning --------------------------------------------------------------
    def pin(self, node: PrefixNode) -> None:
        """Pin while an in-flight consumer depends on ``node``'s source; a
        pinned node (and, transitively, its ancestors — eviction is
        leaf-only) cannot be evicted."""
        node.refs += 1

    def unpin(self, node: PrefixNode) -> None:
        node.refs = max(node.refs - 1, 0)

    # -- insertion ------------------------------------------------------------
    def insert(self, tokens: Sequence[int]
               ) -> Tuple[List[PrefixNode], List[PrefixNode]]:
        """Index the full sequence; splits edges on divergence.

        Returns ``(path, evicted)``: every node whose edge lies on the
        inserted sequence (the caller re-points their physical sources at
        the fresh donor — it holds KV for all of them), and the nodes LRU-
        evicted to restore ``capacity_tokens`` (the caller drops their
        sources).  Splits keep the ORIGINAL node object as the deep child
        so existing pins stay valid; the new split parent is on the insert
        path and receives its source from the caller like any path node."""
        self._tick += 1
        node, i, path = self.root, 0, []
        n = len(tokens)
        while i < n:
            child = node.children.get(tokens[i])
            if child is None:
                leaf = self._mk(tokens[i:], node, node.depth + (n - i))
                node.children[tokens[i]] = leaf
                self.size_tokens += len(leaf.key)
                path.append(leaf)
                i = n
                break
            k = child.key
            j, m = 0, min(len(k), n - i)
            while j < m and k[j] == tokens[i + j]:
                j += 1
            if j < len(k):
                # split child at j: new parent holds the shared k[:j], the
                # original object keeps k[j:] (and its refs/source)
                mid = self._mk(k[:j], node, child.depth - (len(k) - j))
                node.children[tokens[i]] = mid
                mid.children[k[j]] = child
                child.parent = mid
                child.key = k[j:]
                self.splits += 1  # size unchanged: k split across two nodes
                path.append(mid)
                i += j
                node = mid
            else:
                child.tick = self._tick
                path.append(child)
                i += len(k)
                node = child
        self.inserts += 1
        evicted = self._evict(path)
        return path, evicted

    # -- eviction -------------------------------------------------------------
    def _evict(self, protect: List[PrefixNode]) -> List[PrefixNode]:
        """LRU leaf eviction down to capacity.  Skips pinned nodes and the
        just-inserted path; a parent drained of children becomes a leaf and
        is reachable on a later round.  If everything left is pinned or
        protected, the index is allowed to run over budget."""
        out: List[PrefixNode] = []
        if self.size_tokens <= self.capacity_tokens:
            return out
        shielded = {id(p) for p in protect}
        while self.size_tokens > self.capacity_tokens:
            victim = None
            stack = [self.root]
            while stack:
                nd = stack.pop()
                for c in nd.children.values():
                    if c.children:
                        stack.append(c)
                    elif c.refs == 0 and id(c) not in shielded:
                        if victim is None or (c.tick, c.nid) < (victim.tick,
                                                                victim.nid):
                            victim = c
            if victim is None:
                break
            del victim.parent.children[victim.key[0]]
            victim.parent = None
            self.size_tokens -= len(victim.key)
            self.evictions += 1
            self.evicted_tokens += len(victim.key)
            out.append(victim)
        return out

    def evict_unpinned(self) -> List[PrefixNode]:
        """Forced pressure eviction (degradation-ladder rung 1, DESIGN.md
        §12): drop EVERY evictable node — unpinned leaves first, then the
        parents their departure exposes — regardless of the token budget.
        Pinned nodes (in-flight consumers) and their ancestors survive, so
        no live flow loses its KV source.  Returns the evicted nodes; the
        caller drops their physical sources (freeing off-pool store rows)."""
        out: List[PrefixNode] = []
        while True:
            batch: List[PrefixNode] = []
            stack = [self.root]
            while stack:
                nd = stack.pop()
                for c in nd.children.values():
                    if c.children:
                        stack.append(c)
                    elif c.refs == 0:
                        batch.append(c)
            if not batch:
                return out
            for victim in batch:
                del victim.parent.children[victim.key[0]]
                victim.parent = None
                self.size_tokens -= len(victim.key)
                self.evictions += 1
                self.evicted_tokens += len(victim.key)
                out.append(victim)

    # -- introspection --------------------------------------------------------
    def __len__(self) -> int:
        """Number of indexed nodes (excluding the root)."""
        count, stack = 0, [self.root]
        while stack:
            nd = stack.pop()
            count += len(nd.children)
            stack.extend(nd.children.values())
        return count

    def stats(self) -> dict:
        return {"prefix_nodes": len(self),
                "prefix_size_tokens": self.size_tokens,
                "prefix_inserts": self.inserts,
                "prefix_splits": self.splits,
                "prefix_evictions": self.evictions,
                "prefix_evicted_tokens": self.evicted_tokens}
