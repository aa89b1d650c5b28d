# Ordered DAG with the pipeline-graph DSL.
#
# Capability parity with the reference Graph/Node
# (reference: aiko_services/utilities/graph.py:45-150): named nodes with
# ordered successors, deterministic traversal order, and a classmethod that
# parses the s-expression graph DSL  "(a (b d) (c d))"  including per-edge
# property dicts  "(a (b (x: y)))"  used for pipeline fan-in/out name mapping.
#
# Fresh design: explicit topological ordering (Kahn, stable by insertion
# order) rather than DFS emission, plus predecessor maps — the pipeline
# engine needs both to validate dataflow and to schedule stages.
#
# The port's own copy of aiko_services_tpu/utils/graph.py.

from __future__ import annotations

from .sexpr import parse_sexpr

__all__ = ["Graph", "Node", "GraphError"]


class GraphError(ValueError):
    pass


class Node:
    __slots__ = ("name", "element", "properties", "successors")

    def __init__(self, name: str, element=None, properties=None):
        self.name = name
        self.element = element           # payload (e.g. a PipelineElement)
        self.properties = properties or {}   # per-edge properties by head name
        self.successors: list[str] = []

    def add_successor(self, name: str):
        if name not in self.successors:
            self.successors.append(name)

    def __repr__(self):
        return f"Node({self.name} -> {self.successors})"


class Graph:
    """Insertion-ordered DAG of named nodes."""

    def __init__(self, head_names=()):
        self._nodes: dict[str, Node] = {}
        self._head_names = list(head_names)

    # -- construction -----------------------------------------------------
    def add(self, name: str, element=None, properties=None) -> Node:
        if name in self._nodes:
            raise GraphError(f"duplicate node: {name}")
        node = Node(name, element, properties)
        self._nodes[name] = node
        return node

    def add_edge(self, tail: str, head: str):
        # validate the head NOW: a dangling successor used to slip in
        # silently and only surface later in predecessor_map()
        if head not in self._nodes:
            raise GraphError(
                f"add_edge {tail}->{head}: unknown head node {head!r} "
                f"(add it first)")
        self.node(tail).add_successor(head)

    def remove(self, name: str):
        self._nodes.pop(name, None)
        for node in self._nodes.values():
            if name in node.successors:
                node.successors.remove(name)

    # -- access -----------------------------------------------------------
    def node(self, name: str) -> Node:
        try:
            return self._nodes[name]
        except KeyError:
            raise GraphError(f"unknown node: {name}") from None

    def __contains__(self, name):
        return name in self._nodes

    def __len__(self):
        return len(self._nodes)

    def nodes(self):
        return list(self._nodes.values())

    def node_names(self):
        return list(self._nodes)

    @property
    def head_names(self):
        return list(self._head_names)

    def successors(self, name: str):
        return list(self.node(name).successors)

    def predecessors(self, name: str) -> list[str]:
        return [n.name for n in self._nodes.values() if name in n.successors]

    def predecessor_map(self) -> dict[str, list[str]]:
        preds = {name: [] for name in self._nodes}
        for node in self._nodes.values():
            for succ in node.successors:
                if succ not in preds:
                    raise GraphError(
                        f"edge {node.name}->{succ} to undeclared node")
                preds[succ].append(node.name)
        return preds

    # -- ordering ---------------------------------------------------------
    def topological_order(self) -> list[Node]:
        """Stable Kahn topological sort; raises GraphError on cycles."""
        preds = self.predecessor_map()
        indegree = {name: len(p) for name, p in preds.items()}
        ready = [n for n in self._nodes if indegree[n] == 0]
        order = []
        while ready:
            name = ready.pop(0)
            order.append(self._nodes[name])
            for succ in self._nodes[name].successors:
                indegree[succ] -= 1
                if indegree[succ] == 0:
                    ready.append(succ)
        if len(order) != len(self._nodes):
            cyclic = [n for n, d in indegree.items() if d > 0]
            raise GraphError(f"cycle detected involving: {cyclic}")
        return order

    def __iter__(self):
        return iter(self.topological_order())

    def __repr__(self):
        return f"Graph({[n.name for n in self.topological_order()]})"

    # -- DSL --------------------------------------------------------------
    @classmethod
    def traverse(cls, dsl, node_properties_callback=None) -> "Graph":
        """Build a Graph from the s-expression DSL.

        "(a (b d) (c d))" : a→b, a→c, b→d, c→d (diamond).
        "(a (b (x: y)))"  : a→b with edge properties {"x": "y"} recorded on
        node a, keyed by successor name ("b"), and reported via
        node_properties_callback(tail_name, head_name, properties).
        Accepts a single DSL string or a list of strings (multiple heads).
        """
        graph = cls()
        if isinstance(dsl, str):
            dsl = [dsl]
        for expr_text in dsl:
            expr = parse_sexpr(expr_text)
            if isinstance(expr, str):
                expr = [expr]
            if not isinstance(expr, list) or not expr:
                raise GraphError(f"bad graph expression: {expr_text!r}")
            head = cls._traverse_expr(graph, expr, node_properties_callback)
            graph._head_names.append(head)
        return graph

    @staticmethod
    def _ensure(graph: "Graph", name: str) -> Node:
        return graph._nodes[name] if name in graph else graph.add(name)

    @classmethod
    def _traverse_expr(cls, graph, expr, props_cb) -> str:
        """expr = [tail, successor...]; successor = atom | [sub-expr] and an
        optional trailing dict of edge properties.  Returns the tail name."""
        tail_name = expr[0]
        if not isinstance(tail_name, str):
            raise GraphError(f"node name must be an atom, got {tail_name!r}")
        tail = cls._ensure(graph, tail_name)
        for successor in expr[1:]:
            if isinstance(successor, str):
                cls._ensure(graph, successor)
                tail.add_successor(successor)
            elif isinstance(successor, dict):
                raise GraphError(
                    f"edge properties must follow a successor name: "
                    f"{successor!r}")
            elif isinstance(successor, list) and successor:
                # "(b (x: y) d)" — properties dict directly after head name
                head_name = successor[0]
                rest = successor[1:]
                if rest and isinstance(rest[0], dict):
                    properties = rest.pop(0)
                    cls._ensure(graph, head_name)
                    tail.properties[head_name] = properties
                    if props_cb:
                        props_cb(tail_name, head_name, properties)
                sub_head = cls._traverse_expr(
                    graph, [head_name] + rest, props_cb)
                tail.add_successor(sub_head)
            else:
                raise GraphError(f"bad successor: {successor!r}")
        return tail_name
