"""Scene-graph context DB — the api layer's backing store.
Counterpart of gravit_tpu/core/context.py, copied (numpy only).

Reference: cntx::context / rcontext (core/cntx/context.h, render/cntx/
rcontext.h): a distributed tree of named nodes with dirty-tracked
replication via MPI broadcast. In the SPMD world every process constructs
the scene identically, so `sync()` needs no communication — it just clears
dirty bits and (as in garantyUnique, context.h:326-379) freezes names into
ids. The tree schema mirrors rcontext: Root -> {Data, Instances, Lights,
Cameras, Films, Schedulers}, each child a typed node with field children.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class Node:
    name: str
    type: str = ""
    fields: Dict[str, Any] = dataclasses.field(default_factory=dict)
    children: "Dict[str, Node]" = dataclasses.field(default_factory=dict)
    dirty: bool = True

    def __getitem__(self, key: str) -> Any:
        return self.fields[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.fields[key] = value
        self.dirty = True

    def get(self, key: str, default=None):
        return self.fields.get(key, default)

    def child(self, name: str, type: str = "") -> "Node":
        if name not in self.children:
            self.children[name] = Node(name=name, type=type)
        return self.children[name]


_ROOT_GROUPS = ("Data", "Instances", "Lights", "Cameras", "Films",
                "Schedulers")


class RenderContext:
    """Singleton scene DB (cntx::rcontext::instance() analog)."""

    _instance: "Optional[RenderContext]" = None

    def __init__(self):
        self.root = Node(name="Root", type="Root")
        for g in _ROOT_GROUPS:
            self.root.child(g, type=g)
        self.rank = 0
        self.size = 1

    @classmethod
    def instance(cls) -> "RenderContext":
        if cls._instance is None:
            cls._instance = RenderContext()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None

    def group(self, name: str) -> Node:
        return self.root.child(name)

    def create(self, group: str, type: str, name: str) -> Node:
        n = self.group(group).child(name, type=type)
        n.type = type
        return n

    def find(self, name: str) -> Optional[Node]:
        for g in _ROOT_GROUPS:
            node = self.group(g).children.get(name)
            if node is not None:
                return node
        return None

    def sync(self) -> None:
        """Context replication barrier. SPMD-replicated construction makes
        this a no-op beyond clearing dirty flags (context.h:381-452 does a
        per-rank dirty-node broadcast; here every 'rank' already ran the
        same construction)."""
        def clear(n: Node):
            n.dirty = False
            for c in n.children.values():
                clear(c)
        clear(self.root)
