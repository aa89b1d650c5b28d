# graft-check's lint on the port against the JAX package's: the same
# package-neutral fixture sources give the same (rule, line, severity)
# through both packages' lint_source; each rule that matches a JAX idiom
# fires at the same line on a JAX fixture through the JAX lint and on
# its torch counterpart through the port's; lint-kernel-fallback (the
# port's counterpart of lint-pallas-fallback) fires on planted wrappers.

from pathlib import Path

import pytest

from aiko_services_tpu.analysis import lint_source as jax_lint
from aiko_services_tpu.analysis.lint import LINT_RULES as JAX_RULES
from aiko_services_tpu_torch.analysis import (LINT_RULES, main,
                                              rule_catalog)
from aiko_services_tpu_torch.analysis import lint_source as port_lint


def _keys(findings):
    return sorted((f.rule, f.line, f.severity) for f in findings)


def _port_keys(source, path="element.py"):
    return _keys(port_lint(source, path))


# (fixture source, the (rule, line) pairs it must raise; empty = clean)
NEUTRAL = {
    "sleep_in_process_frame": (
        "import time\n"
        "class PE_X:\n"
        "    def process_frame(self, frame):\n"
        "        time.sleep(1)\n",
        {("lint-blocking-call", 4)}),
    "sleep_in_timer_handler": (
        "import time\n"
        "def setup(engine):\n"
        "    def on_tick():\n"
        "        time.sleep(0.5)\n"
        "    engine.add_timer_handler(on_tick, 1.0)\n",
        {("lint-blocking-call", 4)}),
    "sleep_in_message_handler": (
        "import time\n"
        "class Host:\n"
        "    def setup(self, runtime):\n"
        "        runtime.add_message_handler(self._peer_handler,\n"
        "                                    'ns/p/0/peer')\n"
        "    def _peer_handler(self, topic, payload):\n"
        "        time.sleep(0.1)\n",
        {("lint-blocking-call", 7)}),
    "socket_recv_in_handler": (
        "class Host:\n"
        "    def setup(self, runtime):\n"
        "        runtime.add_message_handler(self._on_open, 't')\n"
        "    def _on_open(self, topic, payload):\n"
        "        self.sock.recv(4096)\n",
        {("lint-blocking-call", 5)}),
    "thread_target_exempt": (
        "import time, threading\n"
        "class PE_X:\n"
        "    def start_stream(self, stream):\n"
        "        def capture():\n"
        "            time.sleep(1)\n"
        "        threading.Thread(target=capture).start()\n",
        set()),
    "wrapped_result_waived_on_first_line": (
        "class Element:\n"
        "    def process_frame(self, stream, frame):\n"
        "        value = frame.get(  # graft: disable=lint-blocking-call\n"
        "            'x',\n"
        "            future.result())\n"
        "        return value\n",
        set()),
    "wrapped_result": (
        "class Element:\n"
        "    def process_frame(self, stream, frame):\n"
        "        value = frame.get(\n"
        "            'x',\n"
        "            future.result())\n"
        "        return value\n",
        {("lint-blocking-call", 5)}),
    "raw_lock_and_rlock": (
        "import threading\n"
        "a = threading.Lock()\n"
        "b = threading.RLock()\n",
        {("lint-raw-lock", 2)}),
    "raw_lock_waived": (
        "import threading\n"
        "x = threading.Lock()   # graft: disable=lint-raw-lock\n",
        set()),
    "assert": ("assert x > 0\n", {("lint-assert", 1)}),
    "publish_under_lock": (
        "class Broker:\n"
        "    def send(self):\n"
        "        with self._lock:\n"
        "            self.transport.publish('t', 'p')\n",
        {("lint-publish-locked", 4)}),
    "hot_alloc_np": (
        "import numpy as np\n"
        "class Decoder:\n"
        "    def pump(self):   # graft: hot-path\n"
        "        buf = np.zeros((4,))\n"
        "        return np.asarray(buf)\n",
        {("lint-hot-alloc", 4)}),
    "hot_alloc_unmarked": (
        "import numpy as np\n"
        "def setup():\n"
        "    return np.zeros((4,))\n",
        set()),
    "hot_alloc_waived": (
        "import numpy as np\n"
        "def pump():   # graft: hot-path\n"
        "    return np.zeros(4)   # graft: disable=lint-hot-alloc\n",
        set()),
    "print": ("def report(x):\n    print(x)\n", {("lint-print", 2)}),
    "print_file_waiver": (
        "# graft: disable-file=lint-print\n"
        "def report(x):\n"
        "    print(x)\n",
        set()),
    "unbounded_append": (
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        self.buffer.append(x)\n",
        {("lint-unbounded-queue", 3)}),
    "bounded_append": (
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        self.buffer.append(x)\n"
        "        if len(self.buffer) > 64:\n"
        "            self.buffer.popleft()\n",
        set()),
    "local_list_append": (
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        chunks = []\n"
        "        for part in x:\n"
        "            chunks.append(part)\n"
        "        return chunks\n",
        set()),
    "bare_deque_in_handler": (
        "from collections import deque\n"
        "class A:\n"
        "    def _on_msg(self, topic, payload):\n"
        "        self.ring = deque()\n"
        "        self.ring.append(payload)\n"
        "    def setup(self, rt):\n"
        "        rt.add_message_handler(self._on_msg, 't')\n",
        {("lint-unbounded-queue", 4), ("lint-unbounded-queue", 5)}),
    "maxlen_deque_in_handler": (
        "from collections import deque\n"
        "class A:\n"
        "    def _on_msg(self, topic, payload):\n"
        "        self.ring = deque(maxlen=8)\n"
        "    def setup(self, rt):\n"
        "        rt.add_message_handler(self._on_msg, 't')\n",
        set()),
    "dict_store_in_handler": (
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        self._cache[frame.frame_id] = x\n",
        {("lint-unbounded-cache", 3)}),
    "dict_store_in_hot_path": (
        "def pump(self):   # graft: hot-path\n"
        "    self._results[self._round] = 1\n",
        {("lint-unbounded-cache", 2)}),
    "setdefault_in_handler": (
        "class A:\n"
        "    def _on_msg(self, topic, payload):\n"
        "        self._by_topic.setdefault(topic, []).append(1)\n"
        "    def setup(self, rt):\n"
        "        rt.add_message_handler(self._on_msg, 't')\n",
        {("lint-unbounded-cache", 3), ("lint-unbounded-queue", 3)}),
    "dict_store_with_eviction": (
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        self._cache[frame.frame_id] = x\n"
        "        if len(self._cache) > 64:\n"
        "            self._cache.popitem()\n",
        set()),
    "stream_variables_store": (
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        frame.stream.variables[self.name] = x\n",
        set()),
    "remove_by_handler_identity": (
        "class A:\n"
        "    def setup(self, rt):\n"
        "        rt.event.add_timer_handler(self._tick, 1.0)\n"
        "    def stop(self, rt):\n"
        "        rt.event.remove_timer_handler(self._tick)\n",
        {("lint-linear-timer", 5)}),
    "remove_by_handle": (
        "class A:\n"
        "    def setup(self, rt):\n"
        "        self._timer = rt.event.add_timer_handler(\n"
        "            self._tick, 1.0)\n"
        "    def stop(self, rt):\n"
        "        rt.event.remove_timer_handler(self._timer)\n",
        set()),
    "metric_label_unbounded": (
        "def build(registry, topic):\n"
        "    return registry.counter('invented_family_total', 'doc',\n"
        "                            {'topic': topic})\n",
        {("lint-metric-label", 3)}),
    "metric_label_bounded": (
        "def build(registry, tenant):\n"
        "    return registry.counter('invented_family_total', 'doc',\n"
        "                            {'tenant': tenant})\n",
        set()),
    "wall_clock_aliases": (
        "import time as t\n"
        "import datetime as dt\n"
        "from time import time\n"
        "def stamp(event):\n"
        "    a = t.time()\n"
        "    b = dt.datetime.now()\n"
        "    c = time()\n"
        "    d = event.time()\n"
        "    return a, b, c, d\n",
        {("lint-wall-clock", 5), ("lint-wall-clock", 6),
         ("lint-wall-clock", 7)}),
    "discarded_pool_alloc": (
        "def pump(self):   # graft: hot-path\n"
        "    self.pool.alloc_blocks(4)\n",
        {("lint-paged-free", 2), ("lint-ledger-seam", 2)}),
    "captured_pool_alloc": (
        "def pump(self):   # graft: hot-path\n"
        "    ids = self.pool.alloc_blocks(4)  # graft: disable=lint-ledger-seam\n"
        "    self._slot_blocks.extend(ids)\n",
        set()),
    "syntax_error": ("def broken(:\n", {("lint-parse", 1)}),
}


@pytest.mark.parametrize("name", sorted(NEUTRAL))
def test_neutral_fixture_gives_the_same_findings_in_both(name):
    source, expected = NEUTRAL[name]
    port = _port_keys(source)
    assert port == _keys(jax_lint(source, "element.py"))
    assert {(rule, line) for rule, line, _ in port} == expected


def test_test_paths_are_exempt_in_both():
    for source in ("assert x > 0\n", "def f(x):\n    print(x)\n"):
        assert port_lint(source, "tests/test_x.py") == []
        assert jax_lint(source, "tests/test_x.py") == []


# (JAX fixture, its torch counterpart, rule, line): each translated
# rule fires at the same line on both sides
TRANSLATED = {
    "blocking_sync_device": (
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        y = self._fn(x)\n"
        "        y.block_until_ready()\n",
        "import torch\n"
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        torch.cuda.synchronize()\n",
        "lint-blocking-call", 4),
    "blocking_sync_event": (
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        y = self._fn(x)\n"
        "        y.block_until_ready()\n",
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        done = self._fn(x)\n"
        "        done.synchronize()\n",
        "lint-blocking-call", 4),
    "jit_in_frame": (
        "import jax\n"
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        return jax.jit(lambda v: v)(x)\n",
        "import torch\n"
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        return torch.compile(lambda v: v)(x)\n",
        "lint-jit-hot", 4),
    "graph_capture_in_frame": (
        "import jax\n"
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        return jax.jit(lambda v: v)(x)\n",
        "import torch\n"
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        with torch.cuda.graph(self.graph):\n"
        "            self.out = self.fn(x)\n",
        "lint-jit-hot", 4),
    "graph_object_in_frame": (
        "import jax\n"
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        return jax.jit(lambda v: v)(x)\n",
        "import torch\n"
        "class PE_X:\n"
        "    def process_frame(self, frame, x=None):\n"
        "        self.graph = torch.cuda.CUDAGraph()\n",
        "lint-jit-hot", 4),
    "hot_alloc_constructor": (
        "import jax.numpy as jnp\n"
        "# graft: hot-path\n"
        "def round_plan():\n"
        "    return jnp.full((4,), 1)\n",
        "import torch\n"
        "# graft: hot-path\n"
        "def round_plan():\n"
        "    return torch.full((4,), 1)\n",
        "lint-hot-alloc", 4),
    "hot_alloc_tensor": (
        "import jax.numpy as jnp\n"
        "def pump(self):   # graft: hot-path\n"
        "    return jnp.zeros_like(self.x)\n",
        "import torch\n"
        "def pump(self):   # graft: hot-path\n"
        "    return torch.tensor(self.x)\n",
        "lint-hot-alloc", 3),
    "host_transfer_in_handler": (
        "def process_frame(self, frame):\n"
        "    k_rows, v_rows = self.pool.block_rows(bid)\n"
        "    host = np.asarray(k_rows)\n",
        "def process_frame(self, frame):\n"
        "    k_rows, v_rows = self.pool.block_rows(bid)\n"
        "    host = k_rows.cpu()\n",
        "lint-host-transfer", 3),
    "host_transfer_hot_path": (
        "def pump(self):   # graft: hot-path\n"
        "    stack = jax.device_put(node.v_rows)\n",
        "def pump(self):   # graft: hot-path\n"
        "    stack = node.v_rows.to('cpu')\n",
        "lint-host-transfer", 2),
    "host_transfer_readback": (
        "def pump(self):   # graft: hot-path\n"
        "    stack = jax.device_put(node.v_rows)\n",
        "def pump(self):   # graft: hot-path\n"
        "    first = self.pool.block_rows(b)[0].tolist()\n",
        "lint-host-transfer", 2),
}


@pytest.mark.parametrize("name", sorted(TRANSLATED))
def test_translated_rule_fires_where_the_jax_rule_fires(name):
    jax_source, torch_source, rule, line = TRANSLATED[name]
    assert (rule, line) in {(f.rule, f.line)
                            for f in jax_lint(jax_source, "element.py")}
    assert (rule, line) in {(f.rule, f.line)
                            for f in port_lint(torch_source, "element.py")}


@pytest.mark.parametrize("source", [
    # compiled once, at set-up: not per frame
    "import torch\n"
    "class PE_X:\n"
    "    def __init__(self):\n"
    "        self._fn = torch.compile(lambda v: v)\n",
    # a host copy of ordinary (non-pool) data is the round's job
    "def process_frame(self, frame):\n"
    "    tokens = frame.tokens.cpu()\n",
    # the prefetcher's worker stages off the loop
    "def _stage(self, job):\n"
    "    return job.k_rows.cpu()\n",
    # as_tensor of an existing buffer is a transfer, not a constructor
    "import torch\n"
    "def pump(self):   # graft: hot-path\n"
    "    return torch.as_tensor(self.buffer)\n",
    # the JAX idioms are not the port's: a sync the port cannot reach
    "class PE_X:\n"
    "    def process_frame(self, frame, x=None):\n"
    "        return jax.jit(lambda v: v)(x)\n",
])
def test_translated_rules_leave_their_exemptions_clean(source):
    assert port_lint(source, "element.py") == []


# -- lint-kernel-fallback ---------------------------------------------------

WRAPPER = (
    "import ctypes\n"
    "from .kernels import check, entry, require_cuda\n"
    "\n"
    "{plain}"
    "def scale(x):\n"
    "    if x.device.type == 'cpu':\n"
    "        return scale_reference(x)\n"
    "    require_cuda('scale', x)\n"
    "{launch}"
    "    return x\n")
PLAIN = ("def scale_reference(x):\n"
         "    return x * 2\n"
         "\n")
LAUNCH = ("    library, function = entry('scale', 'aiko_scale',\n"
          "                              [ctypes.c_void_p])\n"
          "    check(library, 'scale', function(x.data_ptr()))\n")
SWALLOWED = ("    try:\n"
             "        library, function = entry('scale', 'aiko_scale',\n"
             "                                  [ctypes.c_void_p])\n"
             "        check(library, 'scale', function(x.data_ptr()))\n"
             "    except RuntimeError:\n"
             "        return scale_reference(x)\n")


def _kernel_findings(source, path="aiko_services_tpu_torch/ops/scale.py"):
    return [(f.rule, f.line) for f in port_lint(source, path)
            if f.rule == "lint-kernel-fallback"]


def test_kernel_wrapper_with_its_plain_version_is_clean():
    assert _kernel_findings(WRAPPER.format(plain=PLAIN, launch=LAUNCH)) \
        == []


def test_kernel_wrapper_without_a_plain_version_fires():
    source = WRAPPER.format(plain="", launch=LAUNCH)
    assert _kernel_findings(source) == [("lint-kernel-fallback", 4)]
    # outside ops/ the wrapper rule does not apply
    assert _kernel_findings(source, "aiko_services_tpu_torch/x.py") == []


def test_kernel_wrapper_swallowing_its_launch_fires():
    source = WRAPPER.format(plain=PLAIN, launch=SWALLOWED)
    assert _kernel_findings(source) == [("lint-kernel-fallback", 15)]


def test_kernels_module_alias_launch_is_seen():
    source = ("from . import kernels\n"
              "def scale(x):\n"
              "    library, function = kernels.load('scale'), None\n"
              "    return x\n")
    assert _kernel_findings(source) == [("lint-kernel-fallback", 2)]


@pytest.mark.parametrize("source, line", [
    ("import triton\n", 1),
    ("import triton.language as tl\n", 1),
    ("from torch.utils.cpp_extension import load_inline\n", 1),
    ("from torch.utils import cpp_extension\n", 1),
    ("import ctypes\nLIB = ctypes.CDLL('libscale.so')\n", 2),
    ("import subprocess\n"
     "subprocess.run(['nvcc', '-o', 'x.so', 'x.cu'], check=True)\n", 2),
    ("from .kernels import build\nbuild(('scale',))\n", 2),
    ("class Scale:\n    import triton\n", 2),
])
def test_toolchain_at_import_time_fires(source, line):
    assert _kernel_findings(source, "aiko_services_tpu_torch/any.py") \
        == [("lint-kernel-fallback", line)]


def test_toolchain_inside_a_function_is_lazy_and_clean():
    source = ("import ctypes\n"
              "from .triton import helpers\n"
              "def launch():\n"
              "    import triton\n"
              "    from torch.utils.cpp_extension import load_inline\n"
              "    return ctypes.CDLL('libscale.so')\n")
    assert _kernel_findings(source, "aiko_services_tpu_torch/any.py") == []


def test_kernel_fallback_waiver():
    source = "import triton  # graft: disable=lint-kernel-fallback\n"
    assert port_lint(source, "aiko_services_tpu_torch/any.py") == []


def test_the_ports_kernel_wrappers_pass_their_rule():
    import pathlib

    import aiko_services_tpu_torch
    from aiko_services_tpu_torch.analysis.lint import lint_paths
    ops = pathlib.Path(aiko_services_tpu_torch.__file__).parent / "ops"
    assert [f for f in lint_paths([ops])
            if f.rule == "lint-kernel-fallback"] == []


# -- the catalog ------------------------------------------------------------

def test_every_rule_is_carried_over_or_translated():
    """The port's rules are the JAX package's, lint-pallas-fallback
    translated into lint-kernel-fallback; the catalog names each
    translated rule's JAX counterpart."""
    assert set(LINT_RULES) == (set(JAX_RULES) - {"lint-pallas-fallback"}) \
        | {"lint-kernel-fallback"}
    catalog = {entry[0]: entry for entry in rule_catalog()}
    assert catalog["lint-kernel-fallback"][4].startswith(
        "lint-pallas-fallback")
    for rule in ("lint-blocking-call", "lint-jit-hot", "lint-hot-alloc",
                 "lint-host-transfer"):
        assert catalog[rule][4].startswith(rule)
        assert catalog[rule][4] != rule     # it names the JAX idiom
    assert all(entry[4] for entry in catalog.values())


def test_rules_flag_prints_each_rule_beside_its_jax_counterpart(capsys):
    assert main(["--rules"]) == 0
    out = capsys.readouterr().out
    assert "lint-kernel-fallback" in out
    assert "JAX: lint-pallas-fallback" in out
    assert "JAX: lint-blocking-call (.block_until_ready())" in out


def test_generated_build_directories_are_not_linted(tmp_path):
    from aiko_services_tpu_torch.analysis.callgraph import iter_python_files
    from aiko_services_tpu_torch.analysis.lint import lint_paths
    source = "import threading\nlock = threading.Lock()\n"
    for folder in ("pkg", "pkg/_build/tree", "pkg/__pycache__"):
        (tmp_path / folder).mkdir(parents=True)
        (tmp_path / folder / "x.py").write_text(source)
    assert [Path(f.path).relative_to(tmp_path).as_posix()
            for f in lint_paths([tmp_path / "pkg"])] == ["pkg/x.py"]
    assert [path.relative_to(tmp_path).as_posix()
            for path in iter_python_files([tmp_path / "pkg"])] == \
        ["pkg/x.py"]
    # a tree that itself sits below _build/ is linted whole
    inner = tmp_path / "pkg" / "_build" / "tree"
    assert len(lint_paths([inner])) == 1
