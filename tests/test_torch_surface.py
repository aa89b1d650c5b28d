"""The surface census: the port's public surface held to the JAX
package's, module by module.

Both packages are read with `ast`; neither is imported.  For every
`.py` file under aiko_services_tpu/ the census collects

  - the public module-level names: `def`, `class` and assignments,
    including those inside `if`, `try` and `with`, and, in a package
    `__init__.py`, every public name it imports (its re-exports);
  - the public methods and properties of each public class;
  - the parameter names of each public function, and of each public
    method (and `__init__`) of a public class.

The port's file at the same relative path under
aiko_services_tpu_torch/ must define or import each name (a module
`__getattr__` that answers a name counts, PEP 562); each class must
carry each method or property as a method, a property or a dataclass
field; and each
function present in both must take each JAX parameter by name, unless
it takes **kwargs.

The only exceptions are the DEPARTURES below: (JAX file, name) → (the
port's counterpart, a one-line reason).  An entry is stale, and fails
the census, when its JAX name no longer exists, when its counterpart is
missing from the port, or when the port has the JAX name after all.

Run it alone: `python -m pytest tests/test_torch_surface.py -q`.
"""

from __future__ import annotations

import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "aiko_services_tpu"
PORT = ROOT / "aiko_services_tpu_torch"

# (JAX file, name) → ("port file:counterpart", reason).  A name is
# `name`, `Class.member`, `function(param)` or `Class.method(param)`.
DEPARTURES = {
    # initialisers: a JAX PRNG key becomes a torch.Generator, and the
    # layer initialisers become the Params modules' init_
    ("models/layers.py", "linear_init"): (
        "models/layers.py:Linear.init_", "a Params module draws its own weights"),
    ("models/layers.py", "layer_norm_init"): (
        "models/layers.py:LayerNorm.init_", "a Params module draws its own weights"),
    ("models/layers.py", "rms_norm_init"): (
        "models/layers.py:RMSNorm.init_", "a Params module draws its own weights"),
    ("models/layers.py", "embedding_init"): (
        "models/layers.py:Embedding.init_", "a Params module draws its own weights"),
    ("models/layers.py", "conv1d_init"): (
        "models/layers.py:Conv1d.init_", "a Params module draws its own weights"),
    ("models/layers.py", "mha_init"): (
        "models/layers.py:MHA", "its Linear projections draw their own weights"),
    ("models/whisper.py", "whisper_init(key)"): (
        "models/whisper.py:whisper_init(generator)", "a torch.Generator for a PRNG key"),
    ("models/llama.py", "llama_init(key)"): (
        "models/llama.py:llama_init(generator)", "a torch.Generator for a PRNG key"),
    ("models/resnet.py", "resnet_init(key)"): (
        "models/resnet.py:resnet_init(generator)", "a torch.Generator for a PRNG key"),
    ("models/detector.py", "detector_init(key)"): (
        "models/detector.py:detector_init(generator)", "a torch.Generator for a PRNG key"),
    ("models/tts.py", "tts_init(key)"): (
        "models/tts.py:tts_init(generator)", "a torch.Generator for a PRNG key"),
    ("models/moe.py", "moe_init(key)"): (
        "models/moe.py:moe_init(generator)", "a torch.Generator for a PRNG key"),
    ("models/vocoder.py", "vocoder_init(key)"): (
        "models/vocoder.py:vocoder_init(generator)", "a torch.Generator for a PRNG key"),
    # KV rows: the port's caches update in place, so each block is a clone
    ("models/layers.py", "slice_kv_rows"): (
        "models/layers.py:slot_kv_blocks", "one call clones a slot's rows block by block"),
    ("models/layers.py", "split_kv_blocks"): (
        "models/layers.py:slot_kv_blocks", "one call clones a slot's rows block by block"),
    ("models/layers.py", "mha(cache)"): (
        "models/layers.py:cached_mha", "attention over an in-place KV cache is its own function"),
    # Pallas interpret mode: the plain version runs for CPU tensors
    ("ops/attention.py", "flash_attention(interpret)"): (
        "ops/attention.py:flash_attention_reference", "CPU tensors take the plain version"),
    ("ops/attention.py", "cross_decode_attention(interpret)"): (
        "ops/attention.py:cross_decode_attention_reference",
        "CPU tensors take the plain version"),
    ("ops/paged_attention.py", "paged_decode_attention(interpret)"): (
        "ops/paged_attention.py:paged_decode_attention_reference",
        "CPU tensors take the plain version"),
    # JAX idioms with no torch counterpart
    ("parallel/train.py", "TrainState.tree_flatten"): (
        "parallel/train.py:TrainState", "a pytree hook; a torch state is a plain object"),
    ("parallel/train.py", "TrainState.tree_unflatten"): (
        "parallel/train.py:TrainState", "a pytree hook; a torch state is a plain object"),
    ("parallel/collectives.py", "pcast_varying"): (
        "parallel/collectives.py:shard_map", "shard_map's varying-type marker; DTensor has none"),
    ("parallel/collectives.py", "shard_map(check_vma)"): (
        "parallel/collectives.py:shard_map", "shard_map's replication checker; DTensor has none"),
    ("parallel/train.py", "make_train_step(donate)"): (
        "parallel/train.py:make_train_step", "the step updates its state in place"),
    ("parallel/pipeline_parallel.py", "StagedExecutor.__init__(donate)"): (
        "parallel/pipeline_parallel.py:StagedExecutor", "a stage's buffers are reused in place"),
    ("compute.py", "ComputeRuntime.register_program(donate_argnums)"): (
        "compute.py:ComputeRuntime.register_program", "eager programs donate nothing"),
    # mesh and training
    ("parallel/mesh.py", "create_mesh(devices)"): (
        "parallel/mesh.py:create_mesh(device)", "one device per rank of the process group"),
    ("parallel/train.py", "make_train_step(optimizer)"): (
        "parallel/train.py:TrainState.__init__(opt_state)", "the state carries its torch optimizer"),
    # decode knobs: read from the same environment variables at decoder
    # construction, not fixed at import
    ("serving.py", "ATTENTION_IMPL"): (
        "serving.py:ContinuousDecoder.__init__", "AIKO_DECODE_ATTENTION, read per decoder"),
    ("serving.py", "KV_WRITE"): (
        "serving.py:ContinuousDecoder.__init__", "AIKO_DECODE_KV, read per decoder"),
    # lint rule: the kernel seam is the port's build-and-launch seam
    ("analysis/lint.py", "PallasFallbackRule"): (
        "analysis/lint.py:KernelFallbackRule", "lint-kernel-fallback checks the CUDA kernel seam"),
    # the CLI: click's groups and options become one argparse parser
    ("cli.py", "pipeline"): ("cli.py:_parser", "the `pipeline` subparser"),
    ("cli.py", "system"): ("cli.py:_parser", "the `system` subparser"),
    ("cli.py", "transport_option"): ("cli.py:_parser", "each subparser's --transport"),
    ("cli.py", "create"): ("cli.py:pipeline_create", "`pipeline create` in argparse"),
    ("cli.py", "show"): ("cli.py:pipeline_show", "`pipeline show` in argparse"),
    ("cli.py", "registrar(transport)"): ("cli.py:registrar(args)", "parsed arguments"),
    ("cli.py", "storage(transport)"): ("cli.py:storage(args)", "parsed arguments"),
    ("cli.py", "recorder(transport)"): ("cli.py:recorder(args)", "parsed arguments"),
    ("cli.py", "dashboard(transport)"): ("cli.py:dashboard(args)", "parsed arguments"),
    ("cli.py", "pipeline_params(definition_pathname)"): (
        "cli.py:pipeline_params(args)", "parsed arguments"),
    ("cli.py", "system_start(transport)"): ("cli.py:system_start(args)", "parsed arguments"),
    ("cli.py", "system_start(state_file)"): ("cli.py:system_start(args)", "parsed arguments"),
    ("cli.py", "system_start(services)"): ("cli.py:system_start(args)", "parsed arguments"),
    ("cli.py", "system_stop(state_file)"): ("cli.py:system_stop(args)", "parsed arguments"),
    ("cli.py", "system_status(state_file)"): ("cli.py:system_status(args)", "parsed arguments"),
    ("cli.py", "system_reset(transport)"): ("cli.py:system_reset(args)", "parsed arguments"),
}

_FUNCTIONS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _targets(target):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for element in target.elts:
            yield from _targets(element)


def _statements(body):
    """The statements of a body, with those nested in if / try / with."""
    for node in body:
        yield node
        if isinstance(node, ast.If):
            yield from _statements(node.body)
            yield from _statements(node.orelse)
        elif isinstance(node, ast.Try):
            yield from _statements(node.body)
            for handler in node.handlers:
                yield from _statements(handler.body)
            yield from _statements(node.orelse)
            yield from _statements(node.finalbody)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            yield from _statements(node.body)


def _params(function) -> tuple[set, bool]:
    """The parameters a caller can name (not *args), and whether the
    function takes **kwargs."""
    args = function.args
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    return names, args.kwarg is not None


class Surface:
    """One module's names as ast sees them."""

    def __init__(self, tree: ast.Module, rel: str):
        self.rel = rel
        self.defined: dict = {}      # name -> its def / class node, or None
        self.imported: set = set()   # names bound by an import
        self.answered: set = set()   # names a module __getattr__ answers
        for node in _statements(tree.body):
            if isinstance(node, _FUNCTIONS + (ast.ClassDef,)):
                self.defined[node.name] = node
                if node.name == "__getattr__":
                    self.answered |= {
                        c.value for c in ast.walk(node)
                        if isinstance(c, ast.Constant)
                        and isinstance(c.value, str)}
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    for name in _targets(target):
                        self.defined.setdefault(name, None)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                    isinstance(node.target, ast.Name):
                self.defined.setdefault(node.target.id, None)
            elif isinstance(node, ast.ImportFrom):
                self.imported |= {a.asname or a.name for a in node.names}
            elif isinstance(node, ast.Import):
                self.imported |= {a.asname or a.name.split(".")[0]
                                  for a in node.names}

    @property
    def names(self) -> set:
        return set(self.defined) | self.imported | self.answered

    def exported(self) -> set:
        """The public names a module offers: its own definitions, and in
        a package __init__.py its re-exports as well."""
        names = {n for n in self.defined if _public(n)}
        if self.rel.endswith("__init__.py"):
            names |= {n for n in self.imported if _public(n)}
        return names

    def classes(self) -> dict:
        return {n: node for n, node in self.defined.items()
                if isinstance(node, ast.ClassDef)}

    def functions(self) -> dict:
        return {n: node for n, node in self.defined.items()
                if isinstance(node, _FUNCTIONS)}

    @staticmethod
    def members(cls: ast.ClassDef) -> dict:
        """A class's methods, properties and fields (class-level
        assignments, dataclass fields included)."""
        out = {}
        for node in _statements(cls.body):
            if isinstance(node, _FUNCTIONS):
                out[node.name] = node
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                out[node.target.id] = None
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    for name in _targets(target):
                        out[name] = None
        return out

    def has(self, spec: str) -> bool:
        """Whether this module has `spec`: a name, `Class.member`,
        `function(param)` or `Class.method(param)`."""
        name, _, param = spec.partition("(")
        param = param.rstrip(")")
        owner, _, member = name.partition(".")
        if member:
            cls = self.classes().get(owner)
            if cls is None:
                return False
            members = self.members(cls)
            if member not in members:
                return False
            function = members[member]
        else:
            if owner not in self.names:
                return False
            function = self.defined.get(owner)
        if not param:
            return True
        if not isinstance(function, _FUNCTIONS):
            return False
        names, kwargs = _params(function)
        return param in names or kwargs


@functools.cache
def surface(root: pathlib.Path, rel: str) -> Surface:
    return Surface(ast.parse((root / rel).read_text()), rel)


def census(jax: Surface, port: Surface) -> list:
    """The JAX names the port's module lacks, as specs."""
    gaps = list(jax.exported() - port.names)
    port_classes, port_functions = port.classes(), port.functions()
    for cname, cls in sorted(jax.classes().items()):
        if not _public(cname) or cname not in port_classes:
            continue
        ours = port.members(port_classes[cname])
        for mname, node in jax.members(cls).items():
            if not isinstance(node, _FUNCTIONS):
                continue
            if _public(mname) and mname not in ours:
                gaps.append(f"{cname}.{mname}")
            elif (_public(mname) or mname == "__init__") and \
                    isinstance(ours.get(mname), _FUNCTIONS):
                gaps += _param_gaps(f"{cname}.{mname}", node, ours[mname])
    for fname, node in sorted(jax.functions().items()):
        if _public(fname) and fname in port_functions:
            gaps += _param_gaps(fname, node, port_functions[fname])
    return sorted(gaps)


def _param_gaps(name: str, jax_fn, port_fn) -> list:
    wanted, _ = _params(jax_fn)
    have, kwargs = _params(port_fn)
    if kwargs:
        return []
    return [f"{name}({p})" for p in sorted(wanted - have)
            if p not in ("self", "cls")]


JAX_FILES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def test_the_census_reads_every_module_of_both_packages():
    assert len(JAX_FILES) >= 100
    assert {"models/whisper.py", "serving.py", "ops/attention.py",
            "cli.py", "native/__init__.py"} <= set(JAX_FILES)


@pytest.mark.parametrize("rel", JAX_FILES)
def test_the_port_has_every_public_name_of_the_jax_module(rel):
    assert (PORT / rel).exists(), f"no port file for {rel}"
    gaps = [g for g in census(surface(JAX, rel), surface(PORT, rel))
            if (rel, g) not in DEPARTURES]
    assert not gaps, f"{rel}: the port lacks {gaps}"


@pytest.mark.parametrize("key", sorted(DEPARTURES), ids=lambda k: "::".join(k))
def test_each_departure_is_current(key):
    """The JAX name exists, the port still lacks it, the counterpart
    exists in the port, and the reason is one line."""
    rel, name = key
    counterpart, reason = DEPARTURES[key]
    jax, port = surface(JAX, rel), surface(PORT, rel)
    assert jax.has(name), f"stale: {rel} has no {name}"
    assert name in census(jax, port), f"stale: the port has {rel} {name}"
    where, _, spec = counterpart.partition(":")
    assert (PORT / where).exists() and surface(PORT, where).has(spec), \
        f"the counterpart {counterpart} is missing"
    assert reason and "\n" not in reason


# Names the port gained to close the census; removing any one of them
# (from an in-memory copy of its module's tree) must make the census
# fail, so none of them is waived by accident.
CLOSED = [
    ("models/whisper.py", "greedy_decode"),
    ("models/moe.py", "moe_init"),
    ("models/__init__.py", "greedy_decode"),
    ("models/__init__.py", "moe_init"),
    ("models/__init__.py", "BPETokenizer"),
    ("models/__init__.py", "init_llama_caches"),
    ("models/__init__.py", "synthesize"),
    ("ops/__init__.py", "AdmissionGate"),
    ("ops/__init__.py", "ShapeBuckets"),
    ("transport/__init__.py", "WIRE_CODECS"),
    ("transport/__init__.py", "encode_envelope"),
    ("elements/speech.py", "load_flat_npz"),
    ("elements/speech.py", "save_flat_npz"),
    ("observe/tracing.py", "Tracer.span"),
    ("observe/metrics.py", "Histogram.quantile"),
    ("transport/memory.py", "MemoryBroker.reset"),
    ("serving.py", "PrefixKVCache.layout"),
    ("native/__init__.py", "NATIVE_AVAILABLE"),
]


def _without(tree: ast.Module, spec: str) -> ast.Module:
    """A copy of `tree` with `spec` (a name, or Class.member) removed:
    its definition, or its alias in an import, or a module __getattr__
    that answers it."""
    import copy

    tree = copy.deepcopy(tree)
    owner, _, member = spec.partition(".")

    def prune(body, name):
        kept = []
        for node in body:
            if isinstance(node, _FUNCTIONS + (ast.ClassDef,)) and (
                    node.name == name or node.name == "__getattr__" and
                    name in Surface(ast.Module([node], []), "")
                    .answered):
                continue
            if isinstance(node, ast.ImportFrom):
                node.names = [a for a in node.names
                              if (a.asname or a.name) != name]
                if not node.names:
                    continue
            for field in ("body", "orelse", "finalbody"):
                if isinstance(getattr(node, field, None), list) and \
                        not isinstance(node, _FUNCTIONS + (ast.ClassDef,)):
                    setattr(node, field, prune(getattr(node, field), name)
                            or [ast.Pass()])
            kept.append(node)
        return kept

    if member:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name == owner:
                node.body = prune(node.body, member) or [ast.Pass()]
    else:
        tree.body = prune(tree.body, owner)
    return tree


@pytest.mark.parametrize("rel,spec", CLOSED, ids=lambda v: str(v))
def test_removing_a_closed_name_fails_the_census(rel, spec):
    port = surface(PORT, rel)
    jax = surface(JAX, rel)
    assert spec not in census(jax, port)
    tree = ast.parse((PORT / rel).read_text())
    cut = Surface(_without(tree, spec), rel)
    assert spec in census(jax, cut)


def test_the_census_sees_a_missing_parameter():
    jax = Surface(ast.parse("def f(a, b=1):\n    pass\n"), "m.py")
    port = Surface(ast.parse("def f(a):\n    pass\n"), "m.py")
    assert census(jax, port) == ["f(b)"]
    kwargs = Surface(ast.parse("def f(a, **kw):\n    pass\n"), "m.py")
    assert census(jax, kwargs) == []


def test_the_census_reads_names_inside_if_and_try_and_fields():
    jax = Surface(ast.parse(
        "try:\n    X = 1\nexcept ImportError:\n    X = None\n"
        "if X:\n    def g():\n        pass\n"
        "class C:\n    @property\n    def p(self):\n        return 1\n"),
        "m.py")
    assert jax.exported() == {"X", "g", "C"}
    port = Surface(ast.parse(
        "from dataclasses import dataclass\nX = 2\n"
        "def __getattr__(name):\n    if name == 'g':\n        return 1\n"
        "@dataclass\nclass C:\n    p: int = 0\n"), "m.py")
    assert census(jax, port) == []
    bare = Surface(ast.parse("X = 2\nclass C:\n    pass\n"), "m.py")
    assert census(jax, bare) == ["C.p", "g"]
