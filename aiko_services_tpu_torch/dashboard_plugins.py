# The dashboard's built-in plugin pages: extra rendering for known
# service protocols.  The port's own copy of
# aiko_services_tpu/dashboard_plugins.py: the ComputeRuntime page shows
# the device (count, platform, kind, memory occupancy) and the batching
# statistics, the lifecycle-manager page the clients and the device
# pool's occupancy, so device health shows next to process health.

from __future__ import annotations

from .dashboard import register_plugin


def _flat(state) -> dict:
    return dict(state.flat_share())


def render_compute(state, fields) -> list:
    share = _flat(state)
    lines = [f"devices: {share.get('device_count', '?')} "
             f"({share.get('platform', '?')}/"
             f"{share.get('device_kind', '?')})  "
             f"programs: {share.get('program_count', '?')}"]
    mesh = {key.split(".", 1)[1]: value for key, value in share.items()
            if key.startswith("mesh.")}
    if mesh:
        lines.append("mesh: " + " × ".join(f"{k}={v}"
                                           for k, v in mesh.items()))
    for key in sorted(share):
        if key.startswith("device.") and key.endswith(".mem_pct"):
            device_id = key.split(".")[1]
            value = share[key]
            mem = "n/a" if value == -1 else f"{value}%"
            lines.append(f"  device {device_id}: mem {mem}")
    for key in sorted(share):
        if key.startswith("batch.") and key.endswith(".mean_size"):
            # program names themselves contain dots (agent.PE_X)
            program = key[len("batch."):-len(".mean_size")]
            wait = share.get(f"batch.{program}.mean_wait_ms", "?")
            count = share.get(f"batch.{program}.batches", "?")
            lines.append(f"  {program}: {count} batches, "
                         f"mean size {share[key]}, wait {wait} ms")
    return lines


def render_lifecycle_manager(state, fields) -> list:
    share = _flat(state)
    lines = [f"clients: {share.get('client_count', '?')}"]
    if "devices_total" in share:
        lines.append(f"device pool: "
                     f"{share.get('devices_allocated', 0)} allocated / "
                     f"{share.get('devices_free', 0)} free of "
                     f"{share.get('devices_total', 0)}")
    for key in sorted(share):
        if key.startswith("placement."):
            lines.append(f"  client {key.split('.', 1)[1]}: {share[key]}")
    return lines


def register_builtins() -> None:
    """(Re-)register the shipped plugin pages.  Re-runnable on purpose:
    import side effects are one-shot, and a test (or embedder) that
    clears the plugin table could otherwise never get these back."""
    register_plugin("compute", render_compute)
    register_plugin("lifecycle_manager", render_lifecycle_manager)


register_builtins()
