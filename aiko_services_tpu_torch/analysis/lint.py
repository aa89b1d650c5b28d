# Event-loop lint: AST rules for the failure modes that only bite under
# load.
#
# The event engine is cooperative — one blocking call in any handler
# stalls EVERY pipeline in the process — and compile-in-frame or
# publish-under-lock bugs pass every unit test, then melt down at the
# 200-stream rung.  These rules are purely lexical (no imports, no
# execution) so they run on user element files too.
#
# The port's copy of the JAX package's lint.  Five rules match a JAX
# idiom there; here they match its torch counterpart, under the same id
# (lint-blocking-call: .synchronize(); lint-jit-hot: torch.compile and
# CUDA-graph capture; lint-hot-alloc: torch constructors;
# lint-host-transfer: .cpu()/.numpy()/.tolist()/.item()/.to("cpu")),
# and lint-pallas-fallback becomes lint-kernel-fallback: every kernel
# wrapper in ops/ keeps its plain version, never falls back to it from
# an except, and no module builds a toolchain at import time.  Each
# rule's `jax` attribute names its JAX counterpart for the catalog.
#
# Architecture: every rule is a small class registered via @rule — it
# declares its id, severity, a one-line catalog `doc`, an `example`
# waiver line, and ONLY the match hooks it needs.  One `_Walker` pass per module drives all of them, maintaining
# the shared state rules used to recompute for themselves: the
# event/hot scope stack, module lock depth, handler registrations, and
# clock-import aliases.  `rule_catalog()` exposes the table for
# `--rules`.
#
# Hot-path marking: a `graft: hot-path` comment on (or directly above)
# a `def` line opts that function into the allocation rule — purely
# lexical, like the waivers, so it works on user element files too.
#
# Waivers: a COMMENT containing `graft: disable=<rule-id>` (or with
# the rule list `all`) suppresses that rule on its statement —
# resolved by statement EXTENT, so a trailing waiver on the first
# physical line of a wrapped call suppresses findings reported on its
# continuation lines.  `graft:
# disable-file=<rule[,rule]>` in a comment waives rules for the whole
# file (deliberate-console scripts such as chip_smoke.py).  Waiver
# comments are found with the tokenizer, so rule ids inside string
# literals (this file's own messages) never self-waive.  Every waiver
# consumed is recorded in the shared WaiverLog; `--self-check` turns
# unconsumed waiver comments into `lint-stale-waiver` warnings so dead
# exceptions get burned down instead of accreting.

from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path

from .findings import ERROR, WARNING, Finding

__all__ = ["lint_file", "lint_paths", "lint_source", "LINT_RULES",
           "LintRule", "WaiverIndex", "WaiverLog", "rule_catalog"]

# block-pool allocator call tails (lint-paged-free): the returned ids
# are the only refcount handle — a discarded result is a leak
_POOL_ALLOC_TAILS = {"alloc_blocks", "alloc_block"}

# device->host transfer calls applied to KV pool-block rows
# (lint-host-transfer): tier crossings are synchronous millisecond
# copies — in a handler they stall every decode round.  Matched
# lexically: a tensor method that copies to the host (or reads a value
# back) whose receiver's source mentions a pool-row expression.
_TRANSFER_TAILS = {"cpu", "numpy", "tolist", "item"}
_POOL_ROW_TOKENS = ("block_rows", "k_rows", "v_rows", "k_pools",
                    "v_pools")


def _to_host(node: ast.Call) -> bool:
    """`x.to("cpu")` / `x.to(device="cpu")`: the host-copy spelling
    of .to()."""
    if _func_tail(node.func) != "to":
        return False
    values = list(node.args[:1]) + [kw.value for kw in node.keywords
                                    if kw.arg == "device"]
    return any(isinstance(value, ast.Constant) and value.value == "cpu"
               for value in values)


def _host_transfer(node: ast.Call):
    """The receiver's source when `node` copies a pool-row tensor to
    the host (the lint-host-transfer match), else None."""
    if not isinstance(node.func, ast.Attribute) or not (
            node.func.attr in _TRANSFER_TAILS or _to_host(node)):
        return None
    receiver = ast.unparse(node.func.value)
    if any(token in receiver for token in _POOL_ROW_TOKENS):
        return receiver
    return None

# wall-epoch clock reads (lint-wall-clock): canonical spellings; call
# targets are CANONICALIZED through the module's actual time/datetime
# import aliases first (_clock_aliases), so `import datetime as dt;
# dt.datetime.now()`, `import time as t; t.time()`, and `from time
# import time; time()` all trip — while an unrelated object attribute
# named .time() does not (no alias resolves it).
_WALL_CLOCK_CALLS = {
    "time.time",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "date.today", "datetime.date.today",
}


def _clock_aliases(tree: ast.AST) -> dict:
    """Local names bound to the time/datetime modules (or their
    wall-clock members) by this module's imports: {name: canonical}."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for entry in node.names:
                if entry.name in ("time", "datetime"):
                    aliases[entry.asname or entry.name] = entry.name
        elif isinstance(node, ast.ImportFrom):
            if node.module == "datetime":
                for entry in node.names:
                    if entry.name in ("datetime", "date"):
                        aliases[entry.asname or entry.name] = \
                            f"datetime.{entry.name}"
            elif node.module == "time":
                for entry in node.names:
                    if entry.name == "time":
                        aliases[entry.asname or entry.name] = \
                            "time.time"
    return aliases


def _canonical_clock_target(target: str, aliases: dict) -> str:
    head, sep, rest = target.partition(".")
    canonical = aliases.get(head)
    if canonical is None:
        return target
    return f"{canonical}.{rest}" if sep else canonical


# metric-factory call tails whose labels= dict the label rule inspects
_METRIC_FACTORIES = {"counter", "gauge", "histogram"}
# identifier fragments that mark a label VALUE as per-request /
# per-session / per-topic — unbounded by construction.  Purely lexical
# (matched against the value expression's source text), like every
# other rule here.
_UNBOUNDED_LABEL_TOKENS = (
    "topic", "session", "sid", "stream_id", "request_id", "hop_id",
    "hop", "client_id", "trace_id", "span_id", "uuid", "frame_id",
)

# evidence that an accumulation target is bounded or shed within the
# same function: any of these appearing against the SAME receiver text
_BOUND_HINTS = (".pop", ".popleft", ".clear", ".maxlen")

_HOT_MARKER = "graft: hot-path"
# array CONSTRUCTORS (fresh allocation per call).  asarray/array and
# as_tensor are deliberately absent: in a hot loop they are host→device
# transfers of existing buffers, which the round cannot avoid.
_ALLOC_TAILS = {"zeros", "ones", "empty", "full", "zeros_like",
                "ones_like", "full_like", "empty_like", "arange",
                "linspace", "eye", "tensor"}
_ALLOC_MODULES = {"np", "numpy", "torch"}

# per-frame program construction (lint-jit-hot): compilation and
# CUDA-graph capture
_COMPILE_CALLS = {"torch.compile", "torch.cuda.graph", "torch.cuda.CUDAGraph",
                  "CUDAGraph", "torch.cuda.make_graphed_callables"}

_HANDLER_REGISTRARS = {
    "add_timer_handler", "add_oneshot_handler", "add_mailbox_handler",
    "add_queue_handler", "add_flatout_handler",
    # transport-inbound handlers run on the event loop too: a blocking
    # call in a message handler — the peer handshake handlers included
    # (transport/peer.py) — stalls every pipeline the same way
    "add_message_handler",
}
_FRAME_METHODS = {"process_frame", "start_stream", "stop_stream"}
_BLOCKING_ATTRS = {
    "result": "concurrent-future .result() blocks until completion",
    "synchronize": "device sync blocks the event loop",
    "recv": "blocking socket receive",
    "recvfrom": "blocking socket receive",
    "accept": "blocking socket accept",
    "wait_for_publish": "broker round-trip blocks the event loop",
}


# directories of generated output, never source: __pycache__, and the
# port's _build/ (kernel and extension libraries, unpacked trees)
_SKIP_DIRS = {"__pycache__", "_build"}


def _skipped(path: Path, under: Path) -> bool:
    """True for a file in a generated directory below `under`."""
    return not _SKIP_DIRS.isdisjoint(path.relative_to(under).parts)


def _is_test_path(path: str) -> bool:
    name = Path(path).name
    parts = Path(path).parts
    return name.startswith("test_") or name == "conftest.py" or \
        "tests" in parts


def _func_tail(node: ast.AST) -> str:
    """Last attribute/name component of a call target ('' when dynamic)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _collect_handlers(tree: ast.AST) -> tuple[set, set]:
    """Names (and lambda node ids) registered as event-engine handlers
    anywhere in the module — including method references like
    self._mailbox_handler."""
    names: set = set()
    lambda_ids: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if _func_tail(node.func) not in _HANDLER_REGISTRARS:
            continue
        target = node.args[0]
        if isinstance(target, ast.Name):
            names.add(target.id)
        elif isinstance(target, ast.Attribute):
            names.add(target.attr)
        elif isinstance(target, ast.Lambda):
            lambda_ids.add(id(target))
    return names, lambda_ids


def _mentions_lock(node: ast.AST) -> bool:
    return "lock" in ast.unparse(node).lower()


def _own_nodes(func_node):
    """Nodes of a function body excluding nested function/lambda
    bodies — those are their own scopes (and call-graph nodes)."""
    stack = list(ast.iter_child_nodes(func_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# waivers — comment-scanned, statement-extent resolved

_WAIVER_RE = re.compile(r"graft:\s*disable=([\w\-]+(?:\s*,\s*[\w\-]+)*)")
_FILE_WAIVER_RE = re.compile(
    r"graft:\s*disable-file=([\w\-]+(?:\s*,\s*[\w\-]+)*)")


def _split_rules(spec: str) -> set:
    return {part.strip() for part in spec.split(",") if part.strip()}


class WaiverIndex:
    """Per-file waiver resolution.

    A waiver is a COMMENT carrying `graft: disable=<rules>`; it covers
    the statement whose extent contains the comment's line (plus the
    immediately following line, preserving the comment-above-the-site
    idiom).  `graft: disable-file=<rules>` covers the whole file.
    """

    def __init__(self, source: str, tree: ast.AST | None = None):
        self.lines = source.splitlines()
        # comment text by 1-based line, via the tokenizer so waiver
        # spellings inside string literals never count
        self.comments: dict[int, str] = {}
        try:
            for token in tokenize.generate_tokens(
                    io.StringIO(source).readline):
                if token.type == tokenize.COMMENT:
                    self.comments[token.start[0]] = token.string
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # unterminated source (mid-edit files): fall back to raw
            # line text, the pre-tokenizer behavior
            for number, text in enumerate(self.lines, start=1):
                if "#" in text:
                    self.comments[number] = text[text.index("#"):]
        self.waiver_lines: dict[int, set] = {}
        self.file_rules: dict[int, set] = {}
        for number, text in self.comments.items():
            match = _FILE_WAIVER_RE.search(text)
            if match:
                self.file_rules[number] = _split_rules(match.group(1))
                continue
            match = _WAIVER_RE.search(text)
            if match:
                self.waiver_lines[number] = _split_rules(match.group(1))
        # statement extents for multi-line waiver resolution
        self._extents: list[tuple[int, int]] = []
        if tree is None:
            try:
                tree = ast.parse(source)
            except SyntaxError:
                tree = None
        if tree is not None:
            for node in ast.walk(tree):
                if isinstance(node, ast.stmt) and \
                        getattr(node, "end_lineno", None):
                    self._extents.append((node.lineno, node.end_lineno))
            self._extents.sort()

    def _statement_extent(self, lineno: int) -> tuple[int, int]:
        """Innermost statement extent containing `lineno` (the latest-
        starting statement whose span covers it)."""
        best = (lineno, lineno)
        for start, end in self._extents:
            if start > lineno:
                break
            if end >= lineno:
                best = (start, end)
        return best

    def candidate_lines(self, lineno: int):
        start, end = self._statement_extent(lineno)
        seen: set = set()
        for number in (lineno, lineno - 1, start, start - 1, end):
            if number >= 1 and number not in seen:
                seen.add(number)
                yield number

    def match(self, rule: str, lineno: int):
        """The waiver-comment line suppressing `rule` at `lineno`, or
        None.  File-level waivers return their own comment line."""
        for number in self.candidate_lines(lineno):
            rules = self.waiver_lines.get(number)
            if rules and (rule in rules or "all" in rules):
                return number
        for number, rules in self.file_rules.items():
            if rule in rules or "all" in rules:
                return number
        return None


class WaiverLog:
    """Cross-file record of which waiver comments actually suppressed
    something — the lint pass AND the interprocedural effects pass both
    feed it, so `--self-check` can flag dead waivers for burn-down."""

    def __init__(self):
        self.sites: dict[str, dict[int, set]] = {}
        self.used: set = set()

    def register(self, path: str, waivers: WaiverIndex) -> None:
        merged = dict(waivers.waiver_lines)
        merged.update(waivers.file_rules)
        self.sites[path] = merged

    def mark_used(self, path: str, lineno: int) -> None:
        self.used.add((path, lineno))

    def stale_findings(self) -> list:
        findings = []
        for path, lines in sorted(self.sites.items()):
            if _is_test_path(path):
                continue
            for lineno in sorted(lines):
                if (path, lineno) not in self.used:
                    rules = ",".join(sorted(lines[lineno]))
                    findings.append(Finding(
                        "lint-stale-waiver", WARNING, path, lineno,
                        f"waiver `graft: disable={rules}` suppresses "
                        f"nothing (syntactic and effect passes both "
                        f"clean here): remove it so the audit trail "
                        f"stays honest"))
        return findings


# ---------------------------------------------------------------------------
# rule registration

_REGISTRY: list = []


def rule(cls):
    """Register a LintRule subclass; declaration order is table order."""
    _REGISTRY.append(cls())
    return cls


class LintRule:
    """One lint rule: id, severity, catalog line, waiver example, and
    only the match hooks it needs.  Hooks left on the base class are
    never dispatched (the walker buckets rules per hook at import)."""

    id = ""
    severity = ERROR
    doc = ""
    example = ""
    # the JAX package's rule id this rule ports ("" = a port-only rule)
    jax = ""

    # module-wide hooks (every node in the file, or the file's tree once)
    def module_call(self, ctx, node):       # pragma: no cover — stub
        raise NotImplementedError

    def module_tree(self, ctx, tree):       # pragma: no cover — stub
        raise NotImplementedError

    def module_assert(self, ctx, node):     # pragma: no cover — stub
        raise NotImplementedError

    # event/hot-context hooks (innermost function is an event handler
    # or carries the hot-path marker; scope says which)
    def context_call(self, ctx, scope, node):   # pragma: no cover
        raise NotImplementedError

    def context_assign(self, ctx, scope, node):  # pragma: no cover
        raise NotImplementedError

    def context_expr(self, ctx, scope, node):   # pragma: no cover
        raise NotImplementedError


class _Scope:
    """One function frame on the walker's scope stack.  Nested defs get
    their OWN scope (a nested thread target may legitimately block;
    nested registered handlers qualify on their own name), so context
    rules never leak into inner functions."""

    __slots__ = ("name", "event", "hot", "_source")

    def __init__(self, name: str, event: bool, hot: bool,
                 node: ast.AST | None = None):
        self.name = name
        self.event = event
        self.hot = hot
        self._source = ""
        if (event or hot) and node is not None:
            try:
                self._source = ast.unparse(node)
            except Exception:   # pragma: no cover — unparse is total
                self._source = ""

    @property
    def active(self) -> bool:
        return self.event or self.hot

    def receiver_bounded(self, receiver: str) -> bool:
        """True when the enclosing function visibly bounds or sheds the
        accumulation target: pops/clears it, checks len() against it,
        deletes entries — or the target is a LOCAL the function itself
        created (a per-call list dies with the call; the rule is about
        state that outlives the handler).  Purely lexical, like the
        waivers."""
        if "." not in receiver and "[" not in receiver and (
                f"{receiver} = " in self._source
                or f"{receiver}: " in self._source):
            return True
        return any(f"{receiver}{hint}" in self._source
                   for hint in _BOUND_HINTS) \
            or f"len({receiver})" in self._source \
            or f"del {receiver}" in self._source

    def cache_exempt(self, receiver: str) -> bool:
        """lint-unbounded-cache exemptions beyond receiver_bounded:
        per-stream scratch space (stream.variables — torn down with
        the stream, the sanctioned keyed-state home for elements) is
        bounded by stream lifetime, not by code in this function."""
        return receiver.endswith("stream.variables") or \
            self.receiver_bounded(receiver)


# ---------------------------------------------------------------------------
# the rules, in catalog order


@rule
class BlockingCallRule(LintRule):
    id = "lint-blocking-call"
    jax = "lint-blocking-call (.block_until_ready())"
    doc = ("time.sleep / .result() / .synchronize() (torch.cuda, an "
           "Event or a Stream) / blocking socket ops reached from an "
           "event-loop context (frame methods and every add_*_handler "
           "registration) — one blocking call stalls every pipeline in "
           "the process")
    example = "future.result()  # graft: disable=lint-blocking-call"

    def context_call(self, ctx, scope, node):
        if not scope.event:
            return
        tail = _func_tail(node.func)
        target = ast.unparse(node.func)
        if target == "time.sleep":
            ctx.report(
                self.id, node,
                f"time.sleep in event-loop context {scope.name!r} "
                f"stalls every pipeline in the process (use a timer "
                f"handler)")
        elif tail in _BLOCKING_ATTRS:
            ctx.report(
                self.id, node,
                f".{tail}() in event-loop context {scope.name!r}: "
                f"{_BLOCKING_ATTRS[tail]}")


@rule
class RawLockRule(LintRule):
    id = "lint-raw-lock"
    jax = "lint-raw-lock"
    doc = ("threading.Lock() where the diagnostic utils.lock.Lock is "
           "required (named holder, misuse errors, lock-order cycle "
           "detection); threading.RLock is exempt")
    example = "threading.Lock()  # graft: disable=lint-raw-lock"

    def module_call(self, ctx, node):
        if ast.unparse(node.func) == "threading.Lock":
            ctx.report(
                self.id, node,
                "raw threading.Lock: use aiko_services_tpu_torch.utils.Lock "
                "(named holder, misuse errors, AIKO_LOCK_CHECK "
                "lock-order cycle detection)")


@rule
class AssertRule(LintRule):
    id = "lint-assert"
    jax = "lint-assert"
    doc = ("`assert` used for validation in non-test code (compiled "
           "away under -O; raise instead)")
    example = "assert ready  # graft: disable=lint-assert"

    def module_assert(self, ctx, node):
        if not ctx.is_test:
            ctx.report(
                self.id, node,
                "assert used for validation in non-test code: compiled "
                "away under python -O — raise ValueError/RuntimeError")


@rule
class PublishLockedRule(LintRule):
    id = "lint-publish-locked"
    jax = "lint-publish-locked"
    doc = ("broker publish/route while holding a lock (delivery can "
           "re-enter or block under the lock)")
    example = "bus.publish(topic, m)  # graft: disable=lint-publish-locked"

    def module_call(self, ctx, node):
        if ctx.lock_depth > 0 and \
                _func_tail(node.func) in ("publish", "route"):
            ctx.report(
                self.id, node,
                f".{_func_tail(node.func)}() while holding a lock: "
                f"delivery can re-enter or block under the lock — "
                f"buffer under the lock, publish after release")


@rule
class JitHotRule(LintRule):
    id = "lint-jit-hot"
    jax = "lint-jit-hot (jax.jit)"
    doc = ("torch.compile or CUDA-graph capture (torch.cuda.graph, "
           "CUDAGraph) in per-frame code (a recompile or recapture per "
           "frame-shape: the classic serving latency cliff)")
    example = "fn = torch.compile(step)  # graft: disable=lint-jit-hot"

    def context_call(self, ctx, scope, node):
        target = ast.unparse(node.func)
        if scope.event and target in _COMPILE_CALLS:
            ctx.report(
                self.id, node,
                f"{target} in per-frame context {scope.name!r}: "
                f"compile or capture the program once in "
                f"__init__/_setup (per-frame compilation recompiles "
                f"per shape, per-frame capture re-records the graph)")


@rule
class HotAllocRule(LintRule):
    id = "lint-hot-alloc"
    jax = "lint-hot-alloc (np/jnp constructors)"
    doc = ("numpy/torch array CONSTRUCTION (np.zeros, torch.full, "
           "arange, torch.tensor, ...) inside a `# graft: hot-path` "
           "function — preallocate in __init__ and refill in place; "
           "transfers (np.asarray / torch.as_tensor of an existing "
           "buffer) are not flagged")
    example = "buf = np.zeros(n)  # graft: disable=lint-hot-alloc"

    def context_call(self, ctx, scope, node):
        tail = _func_tail(node.func)
        target = ast.unparse(node.func)
        if scope.hot and tail in _ALLOC_TAILS and \
                target.rpartition(".")[0] in _ALLOC_MODULES:
            ctx.report(
                self.id, node,
                f"{target}() allocates a fresh array every pass through "
                f"hot path {scope.name!r}: preallocate in "
                f"__init__/_setup and refill in place (per-round host "
                f"allocations are the pump loop's death by a thousand "
                f"cuts)")


@rule
class PrintRule(LintRule):
    id = "lint-print"
    jax = "lint-print"
    doc = ("bare print( in package (non-test) modules: telemetry flows "
           "through utils.logger or the observe registry — deliberate "
           "console CLIs carry waivers (or a file-level "
           "`graft: disable-file=lint-print`)")
    example = "print(report)  # graft: disable=lint-print"

    def module_call(self, ctx, node):
        if isinstance(node.func, ast.Name) and \
                node.func.id == "print" and not ctx.is_test:
            ctx.report(
                self.id, node,
                "bare print( in package module: route telemetry "
                "through utils.logger / the observe metrics registry "
                "(deliberate console output carries a "
                "`graft: disable=lint-print` waiver)")


@rule
class UnboundedQueueRule(LintRule):
    id = "lint-unbounded-queue"
    jax = "lint-unbounded-queue"
    doc = ("accumulation in event-handler contexts with no visible "
           "bound or shed policy: a bare deque() stored beyond the "
           "call, or .append whose receiver is never popped, cleared, "
           "len()-checked, or deleted from")
    example = "self.q.append(x)  # graft: disable=lint-unbounded-queue"

    def context_call(self, ctx, scope, node):
        tail = _func_tail(node.func)
        if scope.event and tail in ("append", "appendleft") and \
                isinstance(node.func, ast.Attribute):
            receiver = ast.unparse(node.func.value)
            if not scope.receiver_bounded(receiver):
                ctx.report(
                    self.id, node,
                    f"{receiver}.{tail}() accumulates in event-loop "
                    f"context {scope.name!r} with no visible "
                    f"bound or shed policy in this function: cap "
                    f"it (maxlen / len() check / shed-oldest) or "
                    f"waive the audited site with `graft: "
                    f"disable=lint-unbounded-queue`")

    def context_assign(self, ctx, scope, node):
        # a bare deque() STORED beyond the call (attribute/subscript
        # target) in an event context is an unbounded cross-frame
        # queue; a per-call local deque dies with the call, mirroring
        # receiver_bounded's local exemption for .append
        if scope.event and isinstance(node.value, ast.Call) and \
                _func_tail(node.value.func) == "deque" and \
                not any(kw.arg == "maxlen"
                        for kw in node.value.keywords) and \
                any(not isinstance(target, ast.Name)
                    for target in node.targets):
            ctx.report(
                self.id, node,
                f"unbounded deque() stored from event-loop context "
                f"{scope.name!r}: give it a maxlen or a shed policy "
                f"— handler-side accumulation without a bound queues "
                f"until deadlines blow instead of shedding at "
                f"admission")


@rule
class UnboundedCacheRule(LintRule):
    id = "lint-unbounded-cache"
    jax = "lint-unbounded-cache"
    doc = ("dict/OrderedDict CACHES mutated from event-handler or "
           "hot-path contexts with no eviction on the same receiver "
           "(subscript store or .setdefault with a dynamic key): one "
           "entry per distinct key forever")
    example = "self.c[k] = v  # graft: disable=lint-unbounded-cache"

    def context_call(self, ctx, scope, node):
        if _func_tail(node.func) == "setdefault" and \
                isinstance(node.func, ast.Attribute) and node.args and \
                not isinstance(node.args[0], ast.Constant):
            receiver = ast.unparse(node.func.value)
            if not scope.cache_exempt(receiver):
                ctx.report(
                    self.id, node,
                    f"{receiver}.setdefault() grows a keyed cache in "
                    f"context {scope.name!r} with no eviction on the "
                    f"same receiver: pop/popitem/clear or a len() "
                    f"budget check must bound it, or waive the audited "
                    f"site with `graft: disable=lint-unbounded-cache`")

    def context_assign(self, ctx, scope, node):
        # a keyed store (`cache[key] = value`) with no eviction on the
        # same receiver: the unbounded-queue rule's sibling for
        # dict/OrderedDict caches — one entry per distinct key forever.
        # Plain Assign only: AugAssign on a subscript (`stats[k] += 1`)
        # mutates an EXISTING entry, the counter idiom, not insertion
        # growth.  Constant keys are exempt (a fixed-field record
        # update cannot grow — `state["latest"] = frame` is a register,
        # not a cache); growth requires a DYNAMIC key.
        for target in node.targets:
            if not isinstance(target, ast.Subscript) or \
                    isinstance(target.slice, ast.Constant):
                continue
            receiver = ast.unparse(target.value)
            if scope.cache_exempt(receiver):
                continue
            ctx.report(
                self.id, node,
                f"{receiver}[...] = stores into a keyed cache in "
                f"context {scope.name!r} with no eviction on "
                f"the same receiver (pop/popitem/clear/del/len() "
                f"budget check): a per-key cache grows FOREVER — "
                f"bound it like the prefix cache's byte budgets, "
                f"or waive the audited site with `graft: "
                f"disable=lint-unbounded-cache`")


@rule
class LinearTimerRule(LintRule):
    id = "lint-linear-timer"
    jax = "lint-linear-timer"
    doc = ("remove_timer_handler called with a handler FUNCTION "
           "instead of a handle: O(n) identity scan per cancel — keep "
           "the handle add_*_handler returned and cancel by it")
    example = "remove_timer_handler(h)  # graft: disable=lint-linear-timer"

    def module_call(self, ctx, node):
        if _func_tail(node.func) == "remove_timer_handler" and node.args:
            arg_tail = _func_tail(node.args[0])
            if arg_tail and arg_tail in ctx.handler_names:
                ctx.report(
                    self.id, node,
                    f"remove_timer_handler({arg_tail}) cancels by "
                    f"HANDLER IDENTITY — a linear scan over every "
                    f"outstanding timer (O(n) at session cardinality): "
                    f"keep the handle add_*_handler returned and cancel "
                    f"by it (O(1) on the timer wheel); the sparse "
                    f"periodic heap's internal scan is the one waived "
                    f"exception")


@rule
class MetricLabelRule(LintRule):
    id = "lint-metric-label"
    jax = "lint-metric-label"
    doc = ("an UNBOUNDED value (topic path, session/stream/request/hop "
           "id) used as a metric label: every distinct value mints a "
           "registry series forever — a cardinality bomb")
    example = 'labels={"tenant": t}  # graft: disable=lint-metric-label'

    # underscores count as separators (unlike \b): "topic_path" and
    # "session_id" must trip on their stems, "inside"/"shop" must not
    _LABEL_TOKEN_RE = re.compile(
        r"(?<![a-z0-9])(" + "|".join(_UNBOUNDED_LABEL_TOKENS)
        + r")(?![a-z0-9])")

    def module_call(self, ctx, node):
        """Inspect the labels= dict (or the third positional argument)
        of a counter/gauge/histogram get-or-create call for unbounded
        label values — dynamic expressions whose source text names a
        per-request identity (topic, session id, hop id, ...), or a
        suspicious label KEY fed a dynamic value."""
        if _func_tail(node.func) not in _METRIC_FACTORIES or \
                ctx.is_test:
            return
        labels_node = None
        for keyword in node.keywords:
            if keyword.arg == "labels":
                labels_node = keyword.value
                break
        if labels_node is None and len(node.args) >= 3:
            labels_node = node.args[2]
        if not isinstance(labels_node, ast.Dict):
            return
        for key_node, value_node in zip(labels_node.keys,
                                        labels_node.values):
            if isinstance(value_node, ast.Constant):
                continue
            value_text = ast.unparse(value_node).lower()
            key_text = "" if key_node is None \
                else ast.unparse(key_node).lower()
            if self._LABEL_TOKEN_RE.search(value_text) or \
                    self._LABEL_TOKEN_RE.search(key_text):
                label = key_text or value_text
                ctx.report(
                    self.id, value_node,
                    f"metric label {label} takes an unbounded value "
                    f"({ast.unparse(value_node)}): every distinct "
                    f"value mints a registry series FOREVER — label by "
                    f"bounded dimensions (tenant, kind, reason, "
                    f"pipeline name) or waive the audited site with "
                    f"`graft: disable=lint-metric-label`")


@rule
class WallClockRule(LintRule):
    id = "lint-wall-clock"
    jax = "lint-wall-clock"
    doc = ("time.time() / datetime.now() / utcnow() / today() in "
           "package modules: use the engine clock for event/deadline "
           "time, monotonic/perf_counter for durations — wall time "
           "breaks virtual-clock determinism")
    example = "time.time()  # graft: disable=lint-wall-clock"

    def module_call(self, ctx, node):
        if not ctx.is_test and _canonical_clock_target(
                ast.unparse(node.func),
                ctx.clock_aliases) in _WALL_CLOCK_CALLS:
            ctx.report(
                self.id, node,
                f"{ast.unparse(node.func)}() reads the wall-epoch "
                f"clock in a package module: use the engine clock "
                f"(runtime.event.clock.now()) for event/deadline "
                f"time, time.monotonic()/perf_counter() for "
                f"durations — wall time breaks virtual-clock "
                f"determinism and merged flight timelines (calendar-"
                f"time sites carry a `graft: disable=lint-wall-clock` "
                f"waiver)")


@rule
class PagedFreeRule(LintRule):
    id = "lint-paged-free"
    jax = "lint-paged-free"
    doc = ("block-pool .alloc_blocks() result DISCARDED in event/hot "
           "contexts: the returned ids are the only refcount handle — "
           "a bare-statement alloc leaks pool blocks forever")
    example = "ids = pool.alloc_blocks(n)  # capture, release at retire"

    def context_expr(self, ctx, scope, node):
        # a bare-statement pool alloc drops the ONLY handle to the
        # allocated blocks' refcounts — nothing can ever release them,
        # so the pool leaks one block set per pass
        if isinstance(node.value, ast.Call) and \
                _func_tail(node.value.func) in _POOL_ALLOC_TAILS and \
                isinstance(node.value.func, ast.Attribute):
            receiver = ast.unparse(node.value.func.value)
            ctx.report(
                self.id, node,
                f"{receiver}.{_func_tail(node.value.func)}() result "
                f"discarded in context {scope.name!r}: the returned "
                f"block ids are the only refcount handle — capture "
                f"them and release at retire, or the pool leaks one "
                f"allocation per pass (waive an audited site with "
                f"`graft: disable=lint-paged-free`)")


# the kernel-launch seam (lint-kernel-fallback): ops/kernels.py's
# loaders a wrapper launches through, and the toolchains no module may
# import or run at import time (the CPU tests import every module on a
# machine with neither nvcc nor triton)
_KERNEL_LOADERS = {"entry", "load"}
_KERNEL_BUILDERS = _KERNEL_LOADERS | {"build", "prepare"}
_TOOLCHAIN_MODULES = ("triton", "torch.utils.cpp_extension")
_TOOLCHAIN_CALLS = {"ctypes.CDLL", "CDLL", "ctypes.cdll.LoadLibrary",
                    "cdll.LoadLibrary", "load_inline"}
_SPAWN_TAILS = {"run", "call", "check_call", "check_output", "Popen",
                "system"}


def _kernel_imports(tree: ast.AST) -> set:
    """Local names this module binds to ops/kernels.py's entry points
    (`from .kernels import entry`), or to the module itself
    (`from . import kernels`)."""
    names: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        module = node.module or ""
        for alias in node.names:
            if module.rpartition(".")[2] == "kernels" and \
                    alias.name in _KERNEL_BUILDERS:
                names.add(alias.asname or alias.name)
            elif alias.name == "kernels":
                names.add(f"{alias.asname or alias.name}.")
    return names


def _kernel_call(node: ast.AST, names: set, tails: set) -> bool:
    """True when `node` calls one of ops/kernels.py's `tails` through a
    name this module imported (`entry(...)` or `kernels.entry(...)`)."""
    if not isinstance(node, ast.Call):
        return False
    target = ast.unparse(node.func)
    head, _, tail = target.rpartition(".")
    if not head:
        return target in tails and target in names
    return tail in tails and (f"{head}." in names
                              or head.rpartition(".")[2] == "kernels")


def _toolchain_module(name: str) -> bool:
    return any(name == module or name.startswith(f"{module}.")
               for module in _TOOLCHAIN_MODULES)


def _import_time_nodes(tree: ast.AST):
    """Every node that runs when the module is imported: module and
    class bodies, not function bodies or lambdas."""
    stack = list(ast.iter_child_nodes(tree))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            stack.extend(node.decorator_list
                         if not isinstance(node, ast.Lambda) else ())
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@rule
class KernelFallbackRule(LintRule):
    id = "lint-kernel-fallback"
    jax = "lint-pallas-fallback (pallas_call without interpret=)"
    doc = ("a kernel wrapper in ops/ (a function launching through "
           "kernels.entry / load) with no `<name>_reference` plain "
           "version in its module, or whose launch sits in a try whose "
           "except falls back to the plain version; or any module that "
           "imports or builds a toolchain at import time (triton, "
           "torch.utils.cpp_extension, ctypes.CDLL, an nvcc "
           "subprocess, a kernels build)")
    example = "import triton  # graft: disable=lint-kernel-fallback"

    def module_tree(self, ctx, tree):
        if ctx.is_test:
            return
        names = _kernel_imports(tree)
        self._import_time(ctx, tree, names)
        if Path(ctx.path).parent.name == "ops":
            self._wrappers(ctx, tree, names)

    def _import_time(self, ctx, tree, names):
        for node in _import_time_nodes(tree):
            if isinstance(node, ast.Import):
                modules = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                base = node.module or ""
                modules = [base] + [f"{base}.{alias.name}"
                                    for alias in node.names]
            else:
                modules = []
            if any(_toolchain_module(name) for name in modules):
                ctx.report(
                    self.id, node,
                    f"{ast.unparse(node)} at import time: the toolchain "
                    f"is on the card's machine only — import it inside "
                    f"the function that launches the kernel, so every "
                    f"module imports where there is no toolchain")
                continue
            if not isinstance(node, ast.Call):
                continue
            target = ast.unparse(node.func)
            spawns_nvcc = _func_tail(node.func) in _SPAWN_TAILS and \
                "nvcc" in ast.unparse(node)
            if target in _TOOLCHAIN_CALLS or spawns_nvcc or \
                    _kernel_call(node, names, _KERNEL_BUILDERS):
                ctx.report(
                    self.id, node,
                    f"{target}() runs at import time: building or "
                    f"loading a kernel belongs in its first launch (or "
                    f"an explicit build step), never in an import")

    def _wrappers(self, ctx, tree, names):
        defined = {node.name for node in ast.walk(tree)
                   if isinstance(node, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
        for func in ast.walk(tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            launches = [node for node in _own_nodes(func)
                        if _kernel_call(node, names, _KERNEL_LOADERS)]
            if not launches:
                continue
            plain = f"{func.name.lstrip('_')}_reference"
            if plain not in defined:
                ctx.report(
                    self.id, func,
                    f"kernel wrapper {func.name!r} launches a compiled "
                    f"kernel but its module defines no plain version "
                    f"{plain!r}: the CPU branch runs it, and the tests "
                    f"and the chip check hold the kernel against it")
            for node in _own_nodes(func):
                if not isinstance(node, ast.Try):
                    continue
                guarded = {id(inner) for statement in node.body
                           for inner in ast.walk(statement)}
                if not any(id(launch) in guarded for launch in launches):
                    continue
                for handler in node.handlers:
                    fallback = [call for call in ast.walk(handler)
                                if isinstance(call, ast.Call) and
                                _func_tail(call.func).endswith(
                                    "_reference")]
                    if fallback:
                        ctx.report(
                            self.id, handler,
                            f"kernel wrapper {func.name!r} catches its "
                            f"launch's failure and runs "
                            f"{_func_tail(fallback[0].func)}() instead: "
                            f"on the card a kernel that does not build "
                            f"or launch must raise, not hand back the "
                            f"plain version's answer")


@rule
class HostTransferRule(LintRule):
    id = "lint-host-transfer"
    jax = "lint-host-transfer (device_put / np.asarray)"
    doc = ("device→host copies of KV pool-block rows (.cpu() / "
           ".numpy() / .tolist() / .item() / .to(\"cpu\") of "
           "block_rows()/k_rows/...) inside event or hot contexts: a "
           "tier crossing is a synchronous per-block copy — route it "
           "through the AsyncPromoter seam")
    example = "k_rows.cpu()  # graft: disable=lint-host-transfer"

    def context_call(self, ctx, scope, node):
        if _host_transfer(node) is not None:
            target = ast.unparse(node.func)
            ctx.report(
                self.id, node,
                f"{target}() copies KV pool-block rows across the "
                f"device/host boundary in context {scope.name!r}: "
                f"a tier crossing is a synchronous per-block copy "
                f"that stalls every decode round — route it "
                f"through the tiered cache's prefetcher seam "
                f"(AsyncPromoter stages off-loop, the loop "
                f"installs staged arrays) or waive the audited "
                f"site with `graft: disable=lint-host-transfer`")


# modules whose pool/host seam calls report into the KV memory ledger
# — a direct seam call anywhere else bypasses attribution
_LEDGER_SEAM_TAILS = ("alloc_blocks", "release_blocks",
                      "put_from_device", "pop_promoted")
_LEDGER_SEAM_MODULES = ("serving.py", "serving_paged.py",
                        "serving_tiered.py", "serving_disagg.py",
                        "serving_chaos.py", "ledger.py")


@rule
class LedgerSeamRule(LintRule):
    id = "lint-ledger-seam"
    jax = "lint-ledger-seam"
    doc = ("direct BlockPool alloc_blocks/release_blocks or host-store "
           "put_from_device/pop_promoted call outside the "
           "ledger-instrumented serving modules: bytes moved there "
           "never reach the KV memory ledger, so per-tenant "
           "attribution silently under-counts")
    example = "pool.alloc_blocks(n)  # graft: disable=lint-ledger-seam"

    def module_call(self, ctx, node):
        tail = _func_tail(node.func)
        if tail not in _LEDGER_SEAM_TAILS or \
                not isinstance(node.func, ast.Attribute):
            return
        if ctx.is_test or Path(ctx.path).name in _LEDGER_SEAM_MODULES:
            return
        receiver = ast.unparse(node.func.value)
        ctx.report(
            self.id, node,
            f"{receiver}.{tail}() outside the ledger-instrumented "
            f"serving modules: this block/byte movement bypasses the "
            f"KV memory ledger — route it through the instrumented "
            f"seams (serving/serving_paged/serving_tiered/"
            f"serving_disagg) or waive an audited site with "
            f"`graft: disable=lint-ledger-seam`")


# stable public rule-id table, in registration (catalog) order —
# lint-parse (the syntax-failure pseudo-rule) and lint-stale-waiver
# (the self-check audit) are emitted outside the registry
LINT_RULES = tuple(entry.id for entry in _REGISTRY)

# rules emitted by the other analysis layers (effects, drift,
# baseline, the waiver audit) — no visitor entry, but the catalog
# must still name them
_LAYER_RULES = (
    ("lint-lock-order", WARNING,
     "static lock-order cycle: a with-lock body (transitively) "
     "acquires a lock that elsewhere (transitively) acquires this one "
     "— the static twin of the AIKO_LOCK_CHECK runtime detector",
     "", "lint-lock-order"),
    ("lint-metric-drift", ERROR,
     "metric family consumed (chip_smoke.py/autoscaler/"
     "dashboard/observe) but never created in any registry — or "
     "created and mentioned nowhere else (warning); hardware-only "
     "fields live in METRIC_DRIFT_ALLOWLIST",
     'registry.value("asr_frames_total")', "lint-metric-drift"),
    ("lint-wire-schema", ERROR,
     "transport/wire.py envelope constants diverge from the committed "
     "analysis/wire_schema.lock — envelope changes must be a "
     "two-sided diff (--update-wire-lock)",
     "", "lint-wire-schema"),
    ("lint-stale-waiver", WARNING,
     "a `graft: disable=` comment that suppressed nothing across the "
     "syntactic AND effect passes — remove it so the audit trail "
     "stays honest",
     "", "lint-stale-waiver"),
    ("baseline-stale", WARNING,
     "a baseline entry that no longer matches any finding — the debt "
     "was paid down; regenerate with --update-baseline",
     "", "baseline-stale"),
)


def rule_catalog() -> list:
    """(id, severity, doc, example, JAX counterpart) per rule,
    visitor-registered rules first, then the layer rules — powers
    `--rules`."""
    return [(entry.id, entry.severity, entry.doc, entry.example,
             entry.jax) for entry in _REGISTRY] + list(_LAYER_RULES)


def _bucket(hook: str) -> tuple:
    return tuple(entry for entry in _REGISTRY
                 if type(entry).__dict__.get(hook) is not None)


_MODULE_CALL_RULES = _bucket("module_call")
_MODULE_TREE_RULES = _bucket("module_tree")
_MODULE_ASSERT_RULES = _bucket("module_assert")
_CONTEXT_CALL_RULES = _bucket("context_call")
_CONTEXT_ASSIGN_RULES = _bucket("context_assign")
_CONTEXT_EXPR_RULES = _bucket("context_expr")


# ---------------------------------------------------------------------------
# the one walker


class _LintContext:
    """Per-module state shared by every rule: reporting (with waiver
    resolution and dedupe), handler registrations, clock aliases, and
    the module-wide lock depth."""

    def __init__(self, path: str, source: str, tree: ast.AST,
                 waiver_log: WaiverLog | None = None):
        self.path = path
        self.is_test = _is_test_path(path)
        self.waivers = WaiverIndex(source, tree)
        self.waiver_log = waiver_log
        self.handler_names, self.lambda_ids = _collect_handlers(tree)
        self.clock_aliases = _clock_aliases(tree)
        self.lock_depth = 0
        self.lines = self.waivers.lines
        self.findings: list = []
        self._seen: set = set()
        if waiver_log is not None:
            waiver_log.register(path, self.waivers)

    def report(self, rule_id: str, node: ast.AST, message: str,
               severity: str = ERROR) -> None:
        key = (rule_id, node.lineno, getattr(node, "col_offset", 0))
        if key in self._seen:
            return
        waived_at = self.waivers.match(rule_id, node.lineno)
        if waived_at is not None:
            if self.waiver_log is not None:
                self.waiver_log.mark_used(self.path, waived_at)
            return
        self._seen.add(key)
        self.findings.append(
            Finding(rule_id, severity, self.path, node.lineno, message))

    def hot_marked(self, node) -> bool:
        """`graft: hot-path` on the def line (or the line above —
        decorator or standalone comment) opts the function into the
        allocation rule."""
        for line_number in (node.lineno, node.lineno - 1):
            if 1 <= line_number <= len(self.lines) and \
                    _HOT_MARKER in self.lines[line_number - 1]:
                return True
        return False


class _Walker(ast.NodeVisitor):
    def __init__(self, ctx: _LintContext):
        self.ctx = ctx
        self._scopes: list = []

    def _scope(self):
        return self._scopes[-1] if self._scopes else None

    # -- scopes ------------------------------------------------------------
    def visit_FunctionDef(self, node):
        ctx = self.ctx
        event = node.name in _FRAME_METHODS or \
            node.name in ctx.handler_names
        hot = ctx.hot_marked(node)
        self._scopes.append(_Scope(node.name, event, hot, node))
        self.generic_visit(node)
        self._scopes.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        event = id(node) in self.ctx.lambda_ids
        self._scopes.append(
            _Scope("<lambda handler>", event, False,
                   node if event else None))
        self.generic_visit(node)
        self._scopes.pop()

    def visit_With(self, node):
        locked = any(_mentions_lock(item.context_expr)
                     for item in node.items)
        if locked:
            self.ctx.lock_depth += 1
        self.generic_visit(node)
        if locked:
            self.ctx.lock_depth -= 1

    # -- dispatch ----------------------------------------------------------
    def visit_Call(self, node):
        for entry in _MODULE_CALL_RULES:
            entry.module_call(self.ctx, node)
        scope = self._scope()
        if scope is not None and scope.active:
            for entry in _CONTEXT_CALL_RULES:
                entry.context_call(self.ctx, scope, node)
        self.generic_visit(node)

    def visit_Assert(self, node):
        for entry in _MODULE_ASSERT_RULES:
            entry.module_assert(self.ctx, node)
        self.generic_visit(node)

    def visit_Assign(self, node):
        scope = self._scope()
        if scope is not None and scope.active:
            for entry in _CONTEXT_ASSIGN_RULES:
                entry.context_assign(self.ctx, scope, node)
        self.generic_visit(node)

    def visit_Expr(self, node):
        scope = self._scope()
        if scope is not None and scope.active:
            for entry in _CONTEXT_EXPR_RULES:
                entry.context_expr(self.ctx, scope, node)
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# public API


def lint_source(source: str, path: str = "<string>",
                waiver_log: WaiverLog | None = None) -> list:
    """Lint one source text; returns Findings."""
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding("lint-parse", ERROR, path, exc.lineno or 0,
                        f"syntax error: {exc.msg}")]
    ctx = _LintContext(path, source, tree, waiver_log)
    _Walker(ctx).visit(tree)
    for entry in _MODULE_TREE_RULES:
        entry.module_tree(ctx, tree)
    return ctx.findings


def lint_file(pathname, waiver_log: WaiverLog | None = None) -> list:
    path = Path(pathname)
    try:
        source = path.read_text(encoding="utf-8")
    except (OSError, UnicodeDecodeError) as exc:
        return [Finding("lint-parse", ERROR, str(path), 0, str(exc))]
    return lint_source(source, str(path), waiver_log)


def lint_paths(paths, waiver_log: WaiverLog | None = None) -> list:
    """Lint files and/or directories (recursive over *.py)."""
    findings: list = []
    for entry in paths:
        path = Path(entry)
        if path.is_dir():
            for file_path in sorted(path.rglob("*.py")):
                if _skipped(file_path, path):
                    continue
                findings.extend(lint_file(file_path, waiver_log))
        else:
            findings.extend(lint_file(path, waiver_log))
    return findings
