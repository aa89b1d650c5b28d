"""Run a function on several gloo ranks of the port, one process each.

The multi-device cases of the port's parallel substrate run as CPU
processes joined by torch.distributed's gloo backend: `run_ranks` spawns
`world` fresh interpreters (the spawn start method: the test process
has threads), each joins one process group through a file store under a
directory the caller owns (never a fixed port, so concurrent test
workers cannot collide), runs `fn(rank, world, *args)` and sends its
result (picklable: numpy arrays, numbers, dicts) back.  Every wait is
bounded: a hung or failed rank fails the call, and every process is
ended before it returns.  The functions run in the children, so they
live in modules that import neither jax nor the JAX package
(tests/torch_spmd_cases.py)."""

import multiprocessing
import os
import queue
import traceback


def _rank_main(fn, rank, world, store, args, results):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            results.put((rank, "ok", fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_ranks(fn, world: int, directory, *args, timeout: float = 120.0):
    """[fn(rank, world, *args) for every rank], in rank order."""
    context = multiprocessing.get_context("spawn")
    results = context.Queue()
    store = os.path.join(str(directory), "gloo_store")
    processes = [context.Process(target=_rank_main, daemon=True,
                                 args=(fn, rank, world, store, args,
                                       results))
                 for rank in range(world)]
    for process in processes:
        process.start()
    got = {}
    try:
        while len(got) < world:
            try:
                rank, status, value = results.get(timeout=timeout)
            except queue.Empty:
                raise AssertionError(
                    f"ranks {sorted(set(range(world)) - set(got))} sent "
                    f"nothing within {timeout} s") from None
            if status != "ok":
                raise AssertionError(f"rank {rank} failed:\n{value}")
            got[rank] = value
        for process in processes:
            process.join(timeout=30.0)
            assert not process.is_alive(), "a rank did not exit"
    finally:
        for process in processes:
            if process.is_alive():
                process.terminate()
                process.join(timeout=10.0)
    return [got[rank] for rank in range(world)]
