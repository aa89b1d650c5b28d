# Interprocedural effect analysis.
#
# The syntactic lint rules go blind the moment the offending call is
# one helper deep: `process_frame` calling `self._flush()` which calls
# `time.sleep` passes lint-blocking-call.  This pass closes that hole:
#
#   1. collect per-function DIRECT effects —
#        blocks     time.sleep / blocking attrs / subprocess / select /
#                   socket.create_connection / builtin open()
#        transfers  host syncs: .synchronize() (torch.cuda, an Event or
#                   a Stream) and .item() — where the JAX package
#                   matches jax.device_get / device_put — and the
#                   pool-row transfer pattern lint-host-transfer
#                   matches (.cpu/.numpy/.tolist/.item/.to("cpu"))
#        allocates  np/torch array constructors (lint-hot-alloc's set)
#        wall_clock the lint-wall-clock canonical call set
#        locks      acquire sites (with-lock / .acquire) plus the
#                   ordering edges they imply
#   2. propagate effects transitively over the call graph to a
#      fixpoint, recording one WITNESS per (function, effect): either
#      the direct leaf site or the call edge the effect arrived
#      through — so every finding can print its provenance chain
#   3. report at the ROOTS: event-loop contexts (frame methods +
#      add_*_handler registrations, package-wide) for blocks /
#      transfers / wall_clock, `graft: hot-path` functions for
#      allocates / transfers — using the SAME rule ids as the
#      syntactic rules, but only for chains of depth ≥ 1 (depth 0 is
#      the syntactic rule's finding; reporting it twice would be noise)
#
# Waivers are honored at ANY frame: a `graft: disable=<rule>` comment
# on the leaf line kills the effect at the source, on an intermediate
# call line severs that edge, and on the root's `def` line silences
# the root — all resolved by statement extent via WaiverIndex, all
# recorded in the shared WaiverLog so the stale-waiver audit sees them.
#
# Lock-order edges: `with lockA:` whose body (transitively) acquires
# lockB yields a static edge A→B, the same relation the runtime
# AIKO_LOCK_CHECK detector builds from actual acquisitions; a static
# cycle is reported as a `lint-lock-order` warning with both edges'
# provenance.

from __future__ import annotations

import ast

from .callgraph import PackageGraph, build_graph
from .findings import ERROR, WARNING, Finding
from .lint import (_ALLOC_MODULES, _ALLOC_TAILS, _BLOCKING_ATTRS,
                   _WALL_CLOCK_CALLS, WaiverLog, _func_tail,
                   _host_transfer, _is_test_path, _mentions_lock,
                   _own_nodes)

__all__ = ["EffectAnalysis", "effect_findings", "EFFECT_RULES"]

# effect kind -> the lint rule id its findings (and waivers) use
EFFECT_RULES = {
    "blocks": "lint-blocking-call",
    "transfers": "lint-host-transfer",
    "allocates": "lint-hot-alloc",
    "wall_clock": "lint-wall-clock",
}

# which roots report which effect kinds
_EVENT_KINDS = ("blocks", "transfers", "wall_clock")
_HOT_KINDS = ("allocates", "transfers")

# host syncs the transfers effect matches on any receiver (the port's
# counterpart of jax.device_get / device_put)
_HOST_SYNC_TAILS = {
    "synchronize": "waits for the device (a host sync)",
    "item": "reads a value back to the host (a host sync)",
}

_SUBPROCESS_CALLS = {
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
}


def _canonical(module, text: str) -> str:
    """Canonicalize a call target's head through the module's import
    aliases: `t.sleep` → `time.sleep`, `sleep` (from time import
    sleep) → `time.sleep`, `dt.datetime.now` → `datetime.datetime.now`.
    """
    head, sep, rest = text.partition(".")
    if head in module.imports:
        base = module.imports[head]
        return f"{base}.{rest}" if sep else base
    entry = module.from_imports.get(head)
    if entry is not None:
        base = f"{entry[0]}.{entry[1]}" if entry[0] else entry[1]
        return f"{base}.{rest}" if sep else base
    return text


def _direct_effects(module, info):
    """Yield (kind, lineno, detail) for every direct effect site in
    the function's own body (nested defs are their own nodes)."""
    for node in _own_nodes(info.node):
        if not isinstance(node, ast.Call):
            continue
        tail = _func_tail(node.func)
        text = ast.unparse(node.func)
        canonical = _canonical(module, text)
        if canonical == "time.sleep":
            yield ("blocks", node.lineno, "time.sleep()")
        elif tail in _BLOCKING_ATTRS:
            yield ("blocks", node.lineno,
                   f".{tail}() — {_BLOCKING_ATTRS[tail]}")
        elif canonical in _SUBPROCESS_CALLS:
            detail = ("spawns a subprocess (fork/exec on this thread)"
                      if canonical == "subprocess.Popen"
                      else "spawns and waits on a subprocess")
            yield ("blocks", node.lineno, f"{canonical}() — {detail}")
        elif canonical in ("select.select",
                           "socket.create_connection"):
            yield ("blocks", node.lineno,
                   f"{canonical}() blocks on I/O readiness")
        elif isinstance(node.func, ast.Name) and \
                node.func.id == "open":
            yield ("blocks", node.lineno,
                   "open() synchronous file I/O")
        if tail in _HOST_SYNC_TAILS and isinstance(node.func,
                                                  ast.Attribute):
            yield ("transfers", node.lineno,
                   f"{text}() {_HOST_SYNC_TAILS[tail]}")
        elif _host_transfer(node) is not None:
            yield ("transfers", node.lineno,
                   f"{text}() copies KV pool-block rows")
        if tail in _ALLOC_TAILS and \
                text.rpartition(".")[0] in _ALLOC_MODULES:
            yield ("allocates", node.lineno,
                   f"{text}() allocates a fresh array")
        if canonical in _WALL_CLOCK_CALLS:
            yield ("wall_clock", node.lineno,
                   f"{text}() reads the wall-epoch clock")


def _lock_name(info, text: str) -> str:
    """Lock identity for the static order graph: `self._x` qualified
    by the owning class so same-named locks on different classes stay
    distinct; everything else qualified by module."""
    if text.startswith("self.") and info.cls is not None:
        return f"{info.cls}.{text[5:]}"
    return f"{info.module}:{text}"


class EffectAnalysis:
    """Build → propagate → report.  Construct with a PackageGraph (or
    use effect_findings() for the one-shot path)."""

    def __init__(self, graph: PackageGraph,
                 waiver_log: WaiverLog | None = None):
        self.graph = graph
        self.waiver_log = waiver_log
        # function key -> {kind: witness}; witness is
        # ("leaf", lineno, detail) | ("call", lineno, callee_key)
        self.effects: dict[str, dict] = {}
        # function key -> {lock name: witness} (same witness shapes)
        self.acquires: dict[str, dict] = {}
        # (outer lock, function key, body call-site lineno, callee)
        self._held_calls: list = []
        # (lock_a, lock_b, "path:line") direct same-function edges
        self._direct_edges: set = set()
        # function key -> [(kind, lineno, detail, waived)]: every direct
        # effect site, waived ones included (reachable_leaves)
        self.sites: dict[str, list] = {}

    # -- stage 1: direct effects ------------------------------------------
    def _waived(self, module, rule: str, lineno: int) -> bool:
        waived_at = module.waivers.match(rule, lineno)
        if waived_at is not None:
            if self.waiver_log is not None:
                self.waiver_log.mark_used(module.path, waived_at)
            return True
        return False

    def _collect_direct(self) -> None:
        for info in self.graph.functions.values():
            module = self.graph.modules[info.module]
            slots = self.effects.setdefault(info.key, {})
            sites = self.sites.setdefault(info.key, [])
            for kind, lineno, detail in _direct_effects(module, info):
                waived = self._waived(module, EFFECT_RULES[kind], lineno)
                sites.append((kind, lineno, detail, waived))
                if kind in slots or waived:
                    continue    # a waiver kills the effect at its source
                slots[kind] = ("leaf", lineno, detail)
            self._collect_locks(module, info)

    def _collect_locks(self, module, info) -> None:
        """Acquire sites and the ordering relation: a with-lock body's
        direct acquires and call sites (edges to the callee's
        transitive acquires resolve after propagation)."""
        held: list = []     # stack of lock names for nested withs

        def walk(node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            if isinstance(node, ast.With):
                names = []
                for item in node.items:
                    if not _mentions_lock(item.context_expr):
                        continue
                    text = ast.unparse(item.context_expr)
                    # strip the .acquire_timeout()/() call suffix so
                    # `with self._lock:` and `with self._lock.held():`
                    # name the same lock
                    text = text.split("(")[0]
                    names.append(_lock_name(info, text))
                for name in names:
                    slot = self.acquires.setdefault(info.key, {})
                    slot.setdefault(name,
                                    ("leaf", node.lineno, name))
                    for outer in held:
                        if outer != name:
                            self._direct_edges.add(
                                (outer, name,
                                 f"{info.path}:{node.lineno}"))
                held.extend(names)
                for child in node.body:
                    walk(child)
                del held[len(held) - len(names):]
                return
            if isinstance(node, ast.Call) and held:
                callee = self._callee_at(info, node.lineno)
                if callee is not None:
                    for outer in held:
                        self._held_calls.append(
                            (outer, info.key, node.lineno, callee))
            for child in ast.iter_child_nodes(node):
                walk(child)

        for child in ast.iter_child_nodes(info.node):
            walk(child)

    def _callee_at(self, info, lineno: int):
        for site in info.calls:
            if site.lineno == lineno:
                return site.callee
        return None

    # -- stage 2: fixpoint propagation ------------------------------------
    def _propagate(self) -> None:
        functions = self.graph.functions
        changed = True
        while changed:
            changed = False
            for info in functions.values():
                module = self.graph.modules[info.module]
                slots = self.effects.setdefault(info.key, {})
                lock_slot = self.acquires.setdefault(info.key, {})
                for site in info.calls:
                    callee_effects = self.effects.get(site.callee)
                    if callee_effects:
                        for kind in callee_effects:
                            if kind in slots:
                                continue
                            if self._waived(module, EFFECT_RULES[kind],
                                            site.lineno):
                                continue    # waiver severs this edge
                            slots[kind] = ("call", site.lineno,
                                           site.callee)
                            changed = True
                    callee_locks = self.acquires.get(site.callee)
                    if callee_locks:
                        for name in callee_locks:
                            if name not in lock_slot:
                                lock_slot[name] = ("call", site.lineno,
                                                   site.callee)
                                changed = True

    def run(self) -> "EffectAnalysis":
        self._collect_direct()
        self._propagate()
        return self

    # -- provenance --------------------------------------------------------
    def chain(self, key: str, kind: str) -> list:
        """Root-to-leaf provenance frames, 'path:line qualname' per
        hop, the leaf frame carrying the offending call's detail."""
        frames: list = []
        current = key
        for _ in range(len(self.graph.functions) + 1):
            info = self.graph.functions[current]
            witness = self.effects[current][kind]
            if witness[0] == "leaf":
                frames.append(f"{info.path}:{witness[1]} "
                              f"{info.qualname} → {witness[2]}")
                break
            frames.append(f"{info.path}:{witness[1]} {info.qualname}")
            current = witness[2]
        return frames

    def reachable_leaves(self, key: str, kind: str) -> list:
        """Every direct `kind` site the function `key` reaches over the
        call graph, itself included, waivers ignored on the way: sorted
        ("path:line qualname → detail", waived) pairs.  The findings
        name one witness per root; this names them all, so a gate can
        hold a root to the leaves it is allowed to reach."""
        seen, stack, leaves = {key}, [key], set()
        while stack:
            info = self.graph.functions[stack.pop()]
            for site_kind, lineno, detail, waived in \
                    self.sites.get(info.key, ()):
                if site_kind == kind:
                    leaves.add((f"{info.path}:{lineno} {info.qualname} "
                                f"→ {detail}", waived))
            for site in info.calls:
                if site.callee not in seen:
                    seen.add(site.callee)
                    stack.append(site.callee)
        return sorted(leaves)

    def lock_order_edges(self) -> set:
        """Static (lock_a, lock_b, provenance) edges: direct nesting
        plus with-lock bodies calling into transitive acquirers."""
        edges = set(self._direct_edges)
        for outer, func_key, lineno, callee in self._held_calls:
            for name in self.acquires.get(callee, {}):
                if name != outer:
                    info = self.graph.functions[func_key]
                    edges.add((outer, name,
                               f"{info.path}:{lineno}"))
        return edges

    def _lock_cycle_findings(self) -> list:
        adjacency: dict[str, dict] = {}
        for a, b, where in sorted(self.lock_order_edges()):
            adjacency.setdefault(a, {}).setdefault(b, where)
        findings = []
        seen_cycles = set()
        for start in sorted(adjacency):
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(adjacency.get(node, {})):
                    if nxt == start and len(path) > 1:
                        cycle = frozenset(path)
                        if cycle in seen_cycles:
                            continue
                        seen_cycles.add(cycle)
                        hops = path + [start]
                        provenance = "; ".join(
                            f"{a}→{b} at "
                            f"{adjacency[a][b]}"
                            for a, b in zip(hops, hops[1:]))
                        findings.append(Finding(
                            "lint-lock-order", WARNING,
                            adjacency[path[-1]][start].rsplit(
                                ":", 1)[0],
                            int(adjacency[path[-1]][start].rsplit(
                                ":", 1)[1]),
                            f"static lock-order cycle "
                            f"{' → '.join(hops)}: {provenance} — "
                            f"acquire in one global order or the "
                            f"runtime detector will fire under load"))
                    elif nxt not in path and len(path) < 6:
                        stack.append((nxt, path + [nxt]))
        return findings

    # -- stage 3: findings -------------------------------------------------
    def findings(self) -> list:
        results: list = []
        roots = [(key, "event", _EVENT_KINDS)
                 for key in sorted(self.graph.event_roots)]
        roots += [(key, "hot", _HOT_KINDS)
                  for key in sorted(self.graph.hot_roots)]
        seen = set()
        for key, root_kind, kinds in roots:
            info = self.graph.functions.get(key)
            if info is None or _is_test_path(info.path):
                continue
            module = self.graph.modules[info.module]
            for kind in kinds:
                witness = self.effects.get(key, {}).get(kind)
                if witness is None or witness[0] != "call":
                    continue    # depth 0 is the syntactic rule's job
                rule = EFFECT_RULES[kind]
                dedup = (rule, key, kind)
                if dedup in seen:
                    continue
                seen.add(dedup)
                # a waiver on the root's def line silences the root
                if self._waived(module, rule, info.lineno):
                    continue
                frames = self.chain(key, kind)
                leaf = frames[-1].rsplit("→", 1)[-1].strip()
                context = "event-loop context" if root_kind == "event" \
                    else "hot path"
                results.append(Finding(
                    rule, ERROR, info.path, witness[1],
                    f"{context} {info.qualname!r} transitively "
                    f"reaches {leaf} ({len(frames) - 1} call(s) "
                    f"deep): every frame below may carry a "
                    f"`graft: disable={rule}` waiver",
                    chain=tuple(frames)))
        results.extend(self._lock_cycle_findings())
        return results


def effect_findings(paths, root=None,
                    waiver_log: WaiverLog | None = None,
                    graph: PackageGraph | None = None) -> list:
    """One-shot: build the call graph over `paths`, run the effect
    analysis, return interprocedural findings."""
    if graph is None:
        graph = build_graph(paths, root)
    return EffectAnalysis(graph, waiver_log).run().findings()
