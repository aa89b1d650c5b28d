"""The port's weight bridge, device policy, kernel build seam and import
boundary (aiko_services_tpu_torch never imports jax or
aiko_services_tpu)."""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiko_services_tpu_torch as port
from aiko_services_tpu.elements.speech import save_flat_npz as jax_save
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.compute import ComputeRuntime
from aiko_services_tpu_torch.event import EventEngine, VirtualClock
from aiko_services_tpu_torch.process import ProcessRuntime
from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.models import whisper as TW
from aiko_services_tpu_torch.ops import kernels

# One intra-op thread per test process: pytest-xdist already runs a
# worker per core, and the first multi-threaded call of torch's
# vectorized exp/cos on a CPU has been seen to return values ~1e-4 off.
torch.set_num_threads(1)

PACKAGE = pathlib.Path(port.__file__).resolve().parent


def _jax_params(dtype=jnp.float32):
    config = JW.WHISPER_PRESETS["test"]
    if dtype != jnp.float32:
        config = JW.WhisperConfig(**{**config.__dict__, "dtype": dtype})
    return config, jax.jit(functools.partial(
        JW.whisper_init, config=config))(jax.random.PRNGKey(0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_bit_exactly(dtype):
    """Every leaf lands under its '.'-joined path with its exact bits (bf16
    travels through f32, which holds every bf16 value)."""
    config, params = _jax_params(getattr(jnp, dtype))
    model = bridge.params_from_numpy(
        jax.tree.map(np.asarray, params),
        TW.WhisperConfig(**{**config.__dict__}), device="cpu")
    flat = bridge.flatten_tree(params)
    named = dict(model.named_parameters())
    assert {name.replace(".", "/") for name in named} == set(flat)
    for name, tensor in named.items():
        assert tensor.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(
            tensor.float().numpy(), flat[name.replace(".", "/")],
            err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_params_cross_bit_exactly_and_round_trip(dtype, tmp_path):
    """A LlamaConfig makes the bridge build a Llama: every leaf of the JAX
    tree lands under its '.'-joined path with its exact bits, and the
    flat-npz form carries the same leaves back out."""
    config = JL.LlamaConfig(**{**JL.LLAMA_PRESETS["tiny"].__dict__,
                               "dtype": getattr(jnp, dtype)})
    params = jax.jit(functools.partial(JL.llama_init, config=config))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(
        jax.tree.map(np.asarray, params),
        TL.LlamaConfig(**config.__dict__), device="cpu")
    assert isinstance(model, TL.Llama)
    flat = bridge.flatten_tree(params)
    named = dict(model.named_parameters())
    assert {name.replace(".", "/") for name in named} == set(flat)
    for name, tensor in named.items():
        assert tensor.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(
            tensor.float().numpy(), flat[name.replace(".", "/")],
            err_msg=name)
    path = str(tmp_path / "llama.npz")
    bridge.save_flat_npz(model, path)
    with np.load(path) as archive:
        assert set(archive.files) == set(flat)
        for key in archive.files:
            np.testing.assert_array_equal(archive[key], flat[key])
    del flat["lm_head/w"]
    with pytest.raises(ValueError, match="missing"):
        bridge.params_from_numpy(flat, TL.LlamaConfig(**config.__dict__),
                                 device="cpu")


def test_params_from_numpy_rejects_a_mismatched_tree():
    config, params = _jax_params()
    tree = jax.tree.map(np.asarray, params)
    del tree["ln_dec"]
    with pytest.raises(ValueError, match="missing"):
        bridge.params_from_numpy(tree, TW.WHISPER_PRESETS["test"],
                                 device="cpu")


def test_flat_npz_round_trip_and_jax_checkpoints(tmp_path):
    config, params = _jax_params()
    t_config = TW.WHISPER_PRESETS["test"]
    jax_path = str(tmp_path / "jax.npz")
    jax_save(params, jax_path)
    from_jax = bridge.load_flat_npz(
        TW.whisper_init(torch.Generator().manual_seed(1), t_config,
                        device="cpu"), jax_path)
    port_path = str(tmp_path / "port.npz")
    bridge.save_flat_npz(from_jax, port_path)
    again = bridge.load_flat_npz(
        TW.whisper_init(torch.Generator().manual_seed(2), t_config,
                        device="cpu"), port_path)
    with np.load(jax_path) as archive:
        for name, tensor in again.named_parameters():
            np.testing.assert_array_equal(
                tensor.numpy(), archive[name.replace(".", "/")])


def test_load_flat_npz_slices_long_position_tables(tmp_path):
    """A checkpoint's 448-row pos_embed loads into a shorter serving
    context as its prefix; any other shape mismatch raises."""
    short = TW.WhisperConfig(**{**TW.WHISPER_PRESETS["test"].__dict__,
                                "n_text_ctx": 32})
    model = TW.whisper_init(torch.Generator().manual_seed(0),
                            TW.WHISPER_PRESETS["test"], device="cpu")
    path = str(tmp_path / "long.npz")
    bridge.save_flat_npz(model, path)
    target = TW.whisper_init(torch.Generator().manual_seed(3), short,
                             device="cpu")
    bridge.load_flat_npz(target, path)
    assert torch.equal(target.pos_embed, model.pos_embed[:32])
    wrong = TW.WhisperConfig(**{**TW.WHISPER_PRESETS["test"].__dict__,
                                "dim": 32, "num_heads": 2})
    with pytest.raises(ValueError, match="shape"):
        bridge.load_flat_npz(TW.whisper_init(
            torch.Generator(), wrong, device="cpu"), path)


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module imports jax or the JAX package, and none imports at
    module level what the card's machine lacks (click, paho,
    sounddevice): PE_Speaker's guarded sounddevice import sits inside
    its process_frame, as in JAX."""
    # _build/ holds what the package generates (kernel libraries), not
    # its source
    sources = sorted(path for path in PACKAGE.rglob("*.py")
                     if "_build" not in path.relative_to(PACKAGE).parts)
    offenders, module_level = [], []
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        top = {id(node) for node in tree.body}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "aiko_services_tpu"):
                    offenders.append(f"{path.relative_to(PACKAGE)}: {name}")
                if root in ("click", "paho", "sounddevice") and \
                        id(node) in top:
                    module_level.append(
                        f"{path.relative_to(PACKAGE)}: {name}")
    assert not offenders, offenders
    assert not module_level, module_level
    names = {str(path.relative_to(PACKAGE)) for path in sources}
    assert {"models/llama.py", "ops/paged_attention.py", "serving.py",
            "serving_paged.py", "event.py", "state/wheel.py", "lease.py",
            "connection.py", "service.py", "share.py", "actor.py",
            "process.py", "pipeline.py", "transport/message.py",
            "transport/memory.py", "observe/tracing.py", "utils/graph.py",
            "utils/configuration.py", "utils/logger.py",
            "utils/importer.py", "utils/lru_cache.py", "elements/audio.py",
            "elements/speech.py", "transport/wire.py", "state/fsm.py",
            "registrar.py", "elements/common.py", "ops/admission.py",
            "observe/journey.py", "utils/backoff.py", "transport/chaos.py",
            "transport/peer.py", "transport/mqtt.py",
            "transport/paho_loopback.py", "process_manager.py",
            "lifecycle.py", "recorder.py", "storage.py",
            "models/tokenizer.py", "cli.py", "__main__.py"} <= names
    assert len(sources) >= 58


def test_importing_every_module_loads_no_jax_click_or_paho():
    """Importing every module of the port, in a fresh interpreter, loads
    none of jax, the JAX package, click or paho."""
    import subprocess
    import sys
    script = (
        "import importlib, pkgutil, sys\n"
        "import aiko_services_tpu_torch as port\n"
        "for info in pkgutil.walk_packages(port.__path__, 'aiko_services_"
        "tpu_torch.'):\n"
        "    if '_build' not in info.name:\n"
        "        importlib.import_module(info.name)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'aiko_services_tpu', 'click', 'paho')))\n")
    result = subprocess.run([sys.executable, "-c", script],
                            capture_output=True, text=True, timeout=120,
                            cwd=PACKAGE.parent)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "[]"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.resolve_device(None)
    broker = MemoryBroker()
    runtime = ProcessRuntime(
        name="host", engine=EventEngine(VirtualClock()),
        transport_factory=lambda on_message, *_: MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ComputeRuntime(runtime, "compute")
    assert runtime.services() == {}      # nothing half-registered
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.whisper_init(torch.Generator(), TW.WHISPER_PRESETS["test"])
    assert port.resolve_device("cpu") == torch.device("cpu")


def test_torch_dtype_maps_every_spelling():
    assert port.torch_dtype(jnp.bfloat16) is torch.bfloat16
    assert port.torch_dtype(jnp.float32) is torch.float32
    assert port.torch_dtype(np.dtype("float32")) is torch.float32
    assert port.torch_dtype("bfloat16") is torch.bfloat16
    assert port.torch_dtype(torch.float16) is torch.float16
    with pytest.raises(ValueError, match="unsupported dtype"):
        port.torch_dtype("int8")


def test_kernel_build_needs_nvcc_and_names_it(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc_path()


def test_kernel_sources_export_the_entries_the_wrappers_bind():
    sources = {name: (PACKAGE / "csrc" / f"{name}.cu").read_text()
               for name in kernels.KERNEL_SOURCES}
    assert "aiko_flash_attention_bf16(" in sources["flash_attention"]
    assert "aiko_cross_decode_attention_bf16(" in \
        sources["cross_decode_attention"]
    assert "aiko_paged_decode_attention(" in sources["paged_decode_attention"]
    for name, text in sources.items():
        assert 'extern "C"' in text and "aiko_error_string" in text
        module = "paged_attention" if name.startswith("paged") \
            else "attention"
        assert f"Replaces: aiko_services_tpu/ops/{module}.py" in text
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    root = PACKAGE.parent
    assert "aiko_services_tpu_torch/_build/" in \
        (root / ".gitignore").read_text().split()


def test_lock_copy_raises_on_misuse():
    from aiko_services_tpu_torch.utils.lock import Lock
    lock = Lock("port.test")
    with pytest.raises(RuntimeError, match="release without acquire"):
        lock.release()
    with lock:
        assert lock._holder == "context-manager"
    assert lock._holder is None
