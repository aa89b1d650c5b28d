# Whole-package call graph for interprocedural analysis.
#
# Purely static, like the lint rules: parse every module once, index
# functions/methods/classes, then resolve call sites with a ladder of
# heuristics ordered strictest-first:
#
#   1. local name → function or nested def in the same scope/module
#   2. from-import → symbol in the imported package module
#   3. module alias prefix (`wire.encode`, `aiko_services_tpu_torch.x.f`)
#   4. `self.` / `cls.` receiver → method on the enclosing class,
#      walking resolved base classes
#   5. typed receiver → a local `x = ClassName(...)` assignment or a
#      `self.attr = ClassName(...)` attribute-type learned from any
#      method of the class
#   6. unique-bare-name fallback → an attribute call whose method name
#      exists exactly ONCE package-wide and is not a ubiquitous verb
#      (`run`, `get`, `close`, ...) — the stoplist keeps this from
#      inventing edges through dict.get or file.close
#
# `functools.partial(f, ...)` contributes an edge to `f` (partials are
# this codebase's handler/callback currency).  `add_*_handler(f)`
# registrations do NOT create an edge from the registering function —
# registering a handler is not calling it — but they DO mark `f` as an
# event-loop ROOT, exactly like the frame methods, which is what the
# effect propagation needs.  Nested defs and lambdas are their own
# nodes reached only by explicit calls, so a nested thread target's
# blocking calls never leak into its parent (mirroring the lint
# scanner's no-descent rule).

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from .lint import (_FRAME_METHODS, _HANDLER_REGISTRARS, _HOT_MARKER,
                   WaiverIndex, _func_tail, _own_nodes, _skipped)

__all__ = ["CallSite", "FunctionInfo", "ModuleInfo", "PackageGraph",
           "build_graph", "iter_python_files"]

# method names too common for the unique-bare-name fallback: a single
# package-wide definition of `close` does not mean every `x.close()`
# is it (file objects, sockets, and queues all spell it the same way)
_COMMON_NAMES = {
    "run", "start", "stop", "close", "open", "get", "put", "set",
    "add", "remove", "update", "read", "write", "send", "recv",
    "publish", "subscribe", "append", "appendleft", "pop", "popleft",
    "clear", "join", "wait", "notify", "notify_all", "acquire",
    "release", "submit", "process", "handle", "emit", "flush",
    "reset", "terminate", "encode", "decode", "parse", "render",
    "main", "copy", "items", "keys", "values", "setdefault", "extend",
    "insert", "index", "count", "sort", "sorted", "format", "strip",
    "split", "lower", "upper", "replace", "match", "search", "group",
    "load", "loads", "dump", "dumps", "save", "map", "collect",
    "exists", "mkdir", "resolve",
    "name", "value", "result", "cancel", "stat", "snapshot", "step",
    "tick", "poll", "drain", "connect", "bind", "accept", "fileno",
    "shutdown", "info", "warning", "error", "debug", "exception",
}


@dataclass
class CallSite:
    lineno: int
    text: str                   # call-target source, for diagnostics
    callee: str | None          # resolved function key, or None
    kind: str = "call"          # call | partial


@dataclass
class FunctionInfo:
    key: str                    # "module_key::Qual.name"
    module: str                 # owning module key
    path: str
    name: str                   # bare name
    qualname: str               # Class.method / outer.<locals>.inner
    lineno: int
    node: ast.AST = field(repr=False)
    cls: str | None = None      # owning class key, when a method
    calls: list = field(default_factory=list)


@dataclass
class ClassInfo:
    key: str                    # "module_key::ClassName"
    module: str
    name: str
    bases: list = field(default_factory=list)       # base source texts
    methods: dict = field(default_factory=dict)     # name -> func key
    attr_types: dict = field(default_factory=dict)  # attr -> class key


class ModuleInfo:
    """One parsed module: tree, waiver index, import maps, and its
    top-level symbol tables."""

    def __init__(self, key: str, path: Path, source: str,
                 tree: ast.AST, is_package: bool = False):
        self.key = key
        self.is_package = is_package
        self.path = str(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.waivers = WaiverIndex(source, tree)
        # alias -> dotted module name ("np" -> "numpy")
        self.imports: dict[str, str] = {}
        # local name -> (dotted module, original symbol name)
        self.from_imports: dict[str, tuple] = {}
        self.functions: dict[str, str] = {}   # top-level name -> key
        self.classes: dict[str, str] = {}     # class name -> class key

    def resolve_module_alias(self, dotted: str) -> str | None:
        """Map a call-target prefix through this module's import
        aliases: 'wire' -> 'aiko_services_tpu_torch.transport.wire'."""
        if dotted in self.imports:
            return self.imports[dotted]
        head, sep, rest = dotted.partition(".")
        if sep and head in self.imports:
            return f"{self.imports[head]}.{rest}"
        entry = self.from_imports.get(head)
        if entry is not None:
            # `from aiko_services_tpu_torch import transport` style: the
            # imported symbol may itself be a module
            dotted_head = f"{entry[0]}.{entry[1]}"
            return f"{dotted_head}.{rest}" if sep else dotted_head
        return None


def iter_python_files(paths):
    """The analysis file set: files and/or directories (recursive over
    *.py, skipping __pycache__ and _build), deduplicated, in sorted
    order."""
    seen = set()
    for entry in paths:
        path = Path(entry)
        if path.is_dir():
            candidates = sorted(path.rglob("*.py"))
        elif path.suffix == ".py" and path.exists():
            candidates = [path]
        else:
            candidates = []
        for file_path in candidates:
            if path.is_dir() and _skipped(file_path, path):
                continue
            resolved = file_path.resolve()
            if resolved not in seen:
                seen.add(resolved)
                yield file_path


def _module_key(path: Path, root: Path) -> str:
    """Dotted module name relative to the repo root — the name the
    import maps resolve against ('aiko_services_tpu_torch.transport.wire',
    'chip_smoke')."""
    try:
        relative = path.resolve().relative_to(root.resolve())
    except ValueError:
        relative = Path(path.name)
    parts = list(relative.parts)
    if parts[-1] == "__init__.py":
        parts = parts[:-1] or [path.parent.name]
    else:
        parts[-1] = parts[-1][:-3] if parts[-1].endswith(".py") \
            else parts[-1]
    return ".".join(parts)


def _resolve_import_from(module: ModuleInfo,
                         node: ast.ImportFrom) -> str:
    """Absolute dotted module for a (possibly relative) from-import."""
    if not node.level:
        return node.module or ""
    parts = module.key.split(".")
    # level 1 = the current package: a plain module drops its own leaf,
    # a package __init__ IS its package and drops nothing
    drop = node.level - (1 if module.is_package else 0)
    base = parts[:len(parts) - drop] if drop <= len(parts) else []
    if node.module:
        base = base + node.module.split(".")
    return ".".join(base)


class PackageGraph:
    def __init__(self, root: Path):
        self.root = root
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.event_roots: set[str] = set()
        self.hot_roots: set[str] = set()
        # bare method/function name -> [keys] for the unique fallback
        self._bare: dict[str, list] = {}

    # -- symbol lookup -----------------------------------------------------
    def module_function(self, module_key: str, name: str) -> str | None:
        module = self.modules.get(module_key)
        if module is None:
            return None
        if name in module.functions:
            return module.functions[name]
        class_key = module.classes.get(name)
        if class_key is not None:
            # calling a class = running its __init__
            return self.classes[class_key].methods.get("__init__")
        entry = module.from_imports.get(name)
        if entry is not None and entry[0] in self.modules:
            return self.module_function(entry[0], entry[1])
        return None

    def module_class(self, module_key: str, name: str) -> str | None:
        module = self.modules.get(module_key)
        if module is None:
            return None
        if name in module.classes:
            return module.classes[name]
        entry = module.from_imports.get(name)
        if entry is not None and entry[0] in self.modules:
            return self.module_class(entry[0], entry[1])
        head, sep, tail = name.partition(".")
        if sep:
            target = module.resolve_module_alias(head)
            if target is not None and target in self.modules:
                return self.module_class(target, tail)
        return None

    def method_on(self, class_key: str | None, name: str,
                  depth: int = 0) -> str | None:
        """Method lookup walking resolved base classes (depth-capped:
        base texts are source strings, cycles are conceivable)."""
        if class_key is None or depth > 5:
            return None
        info = self.classes.get(class_key)
        if info is None:
            return None
        if name in info.methods:
            return info.methods[name]
        for base_text in info.bases:
            base_key = self.module_class(info.module, base_text)
            if base_key is not None and base_key != class_key:
                found = self.method_on(base_key, name, depth + 1)
                if found is not None:
                    return found
        return None

    def unique_bare(self, name: str) -> str | None:
        if name in _COMMON_NAMES or name.startswith("__"):
            return None
        keys = self._bare.get(name)
        return keys[0] if keys is not None and len(keys) == 1 else None


# ---------------------------------------------------------------------------
# graph construction


def _hot_marked(module: ModuleInfo, node) -> bool:
    for line_number in (node.lineno, node.lineno - 1):
        if 1 <= line_number <= len(module.lines) and \
                _HOT_MARKER in module.lines[line_number - 1]:
            return True
    return False


def _index_module(graph: PackageGraph, module: ModuleInfo) -> None:
    """First pass: imports, classes/methods, functions (incl. nested),
    class attribute types, hot markers."""
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for entry in node.names:
                module.imports[entry.asname
                               or entry.name.partition(".")[0]] = \
                    entry.name if entry.asname else \
                    entry.name.partition(".")[0]
                if entry.asname:
                    module.imports[entry.asname] = entry.name
        elif isinstance(node, ast.ImportFrom):
            source_module = _resolve_import_from(module, node)
            for entry in node.names:
                if entry.name == "*":
                    continue
                module.from_imports[entry.asname or entry.name] = \
                    (source_module, entry.name)

    def add_function(node, qualname, cls_key=None):
        key = f"{module.key}::{qualname}"
        info = FunctionInfo(key=key, module=module.key,
                            path=module.path, name=node.name,
                            qualname=qualname, lineno=node.lineno,
                            node=node, cls=cls_key)
        graph.functions[key] = info
        graph._bare.setdefault(node.name, []).append(key)
        if node.name in _FRAME_METHODS:
            graph.event_roots.add(key)
        if _hot_marked(module, node):
            graph.hot_roots.add(key)
        return key

    def walk_body(body, prefix, cls_key=None):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                key = add_function(node, qual, cls_key)
                if cls_key is not None:
                    graph.classes[cls_key].methods[node.name] = key
                walk_body(node.body, f"{qual}.<locals>.", None)
            elif isinstance(node, ast.ClassDef):
                class_key = f"{module.key}::{prefix}{node.name}"
                graph.classes[class_key] = ClassInfo(
                    key=class_key, module=module.key, name=node.name,
                    bases=[ast.unparse(base) for base in node.bases])
                if not prefix:
                    module.classes[node.name] = class_key
                walk_body(node.body, f"{prefix}{node.name}.",
                          class_key)
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                # conditional/guarded top-level defs still count
                walk_body(getattr(node, "body", []), prefix, cls_key)
                for handler in getattr(node, "handlers", []):
                    walk_body(handler.body, prefix, cls_key)
                walk_body(getattr(node, "orelse", []), prefix, cls_key)
                walk_body(getattr(node, "finalbody", []), prefix,
                          cls_key)

    walk_body(module.tree.body, "")
    for key, info in graph.functions.items():
        if info.module == module.key and "." not in info.qualname:
            module.functions[info.name] = key


def _learn_attr_types(graph: PackageGraph, module: ModuleInfo) -> None:
    """`self.attr = ClassName(...)` in any method teaches the class
    that `self.attr` is a ClassName — the receiver-type heuristic."""
    for info in list(graph.functions.values()):
        if info.module != module.key or info.cls is None:
            continue
        cls = graph.classes[info.cls]
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Assign) or \
                    not isinstance(node.value, ast.Call):
                continue
            ctor = ast.unparse(node.value.func)
            class_key = graph.module_class(module.key, ctor)
            if class_key is None:
                continue
            for target in node.targets:
                if isinstance(target, ast.Attribute) and \
                        isinstance(target.value, ast.Name) and \
                        target.value.id == "self":
                    cls.attr_types.setdefault(target.attr, class_key)


def _resolve_callable_ref(graph, module, info, node,
                          local_types, nested):
    """Resolve a reference to a callable (handler / partial argument /
    call target) to a function key, or None."""
    if isinstance(node, ast.Name):
        if node.id in nested:
            return nested[node.id]
        return graph.module_function(module.key, node.id)
    if not isinstance(node, ast.Attribute):
        return None
    name = node.attr
    receiver = node.value
    receiver_text = ast.unparse(receiver)
    # self./cls. → enclosing class (and its bases)
    if receiver_text in ("self", "cls") and info.cls is not None:
        return graph.method_on(info.cls, name)
    # module alias prefix: wire.encode, functools.partial, pkg.mod.f —
    # and a DEFINITE bail for external modules (np.save, torch.cuda.synchronize):
    # a known-foreign receiver must never reach the unique-bare guess
    head = receiver_text.partition(".")[0]
    if head in module.imports:
        target_module = module.resolve_module_alias(receiver_text)
        if target_module is not None and target_module in graph.modules:
            return graph.module_function(target_module, name)
        return None
    target_module = module.resolve_module_alias(receiver_text)
    if target_module is not None and target_module in graph.modules:
        return graph.module_function(target_module, name)
    # self.attr receiver with a learned attribute type
    if isinstance(receiver, ast.Attribute) and \
            isinstance(receiver.value, ast.Name) and \
            receiver.value.id == "self" and info.cls is not None:
        attr_class = graph.classes[info.cls].attr_types.get(
            receiver.attr)
        if attr_class is not None:
            found = graph.method_on(attr_class, name)
            if found is not None:
                return found
    # local var with an inferred constructor type
    if isinstance(receiver, ast.Name):
        var_class = local_types.get(receiver.id)
        if var_class is not None:
            found = graph.method_on(var_class, name)
            if found is not None:
                return found
    # ClassName.method as an unbound reference
    class_key = graph.module_class(module.key, receiver_text)
    if class_key is not None:
        found = graph.method_on(class_key, name)
        if found is not None:
            return found
    return graph.unique_bare(name)


def _extract_calls(graph: PackageGraph, module: ModuleInfo,
                   info: FunctionInfo) -> None:
    """Second pass per function: local type inference, then one
    CallSite per own-body call, partial edge, and handler-root mark."""
    # nested-def keys follow _index_module's qualname scheme
    nested = {
        child.name:
            f"{module.key}::{info.qualname}.<locals>.{child.name}"
        for child in ast.iter_child_nodes(info.node)
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))}
    local_types: dict[str, str] = {}
    for node in _own_nodes(info.node):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call):
            class_key = graph.module_class(
                module.key, ast.unparse(node.value.func))
            if class_key is not None:
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        local_types[target.id] = class_key
    for node in _own_nodes(info.node):
        if not isinstance(node, ast.Call):
            continue
        tail = _func_tail(node.func)
        text = ast.unparse(node.func)
        # handler registration: marks the target an event ROOT, not an
        # edge — registering is not calling
        if tail in _HANDLER_REGISTRARS and node.args:
            target_key = _resolve_callable_ref(
                graph, module, info, node.args[0], local_types, nested)
            if target_key is not None:
                graph.event_roots.add(target_key)
            continue
        # functools.partial(f, ...): edge to f — partials are the
        # callback currency, the partial's caller will invoke f
        if tail == "partial" and node.args and \
                text in ("functools.partial", "partial"):
            target_key = _resolve_callable_ref(
                graph, module, info, node.args[0], local_types, nested)
            if target_key is not None:
                info.calls.append(CallSite(
                    lineno=node.lineno,
                    text=ast.unparse(node.args[0]),
                    callee=target_key, kind="partial"))
            continue
        callee = _resolve_callable_ref(
            graph, module, info, node.func, local_types, nested)
        if callee is not None and callee != info.key:
            info.calls.append(CallSite(lineno=node.lineno, text=text,
                                       callee=callee))


def build_graph(paths, root=None) -> PackageGraph:
    """Parse every python file under `paths` and return the resolved
    package call graph.  `root` anchors dotted module names (defaults
    to the repo root: the analysis package's grandparent)."""
    if root is None:
        root = Path(__file__).resolve().parents[2]
    graph = PackageGraph(Path(root))
    for file_path in iter_python_files(paths):
        try:
            source = file_path.read_text(encoding="utf-8")
            tree = ast.parse(source)
        except (OSError, UnicodeDecodeError, SyntaxError):
            continue        # lint reports parse failures; skip here
        key = _module_key(file_path, graph.root)
        graph.modules[key] = ModuleInfo(
            key, file_path, source, tree,
            is_package=file_path.name == "__init__.py")
    for module in graph.modules.values():
        _index_module(graph, module)
    for module in graph.modules.values():
        _learn_attr_types(graph, module)
    for info in graph.functions.values():
        _extract_calls(graph, graph.modules[info.module], info)
    return graph
