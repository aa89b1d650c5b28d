"""The port's prefix cache bookkeeping (PrefixKVCache over a BlockPool)
against the JAX package's, call for call.

Both packages' caches keep their blocks in a paged pool (the port has no
other storage): each script allocates pool blocks, registers them with
insert_block and drops its own refs, as the JAX cache's paged install
does.  The scenarios are those of tests/test_prefix_cache.py:226-285
(leaf-first LRU eviction, session pins, tenant budgets, an insert
refused when everything is pinned) and the session and purge surface;
after every call the scripts record the cache's nodes in LRU order, their
refs and pool ids, the byte accounting, the pool's live blocks and the
event counters, and the two records must be equal.  Also: the chain keys
byte for byte, the block geometry check, and the pool's block copy,
install and read against the JAX pool's on the same seeded rows
(exact)."""

import dataclasses

import numpy as np
import pytest

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.observe.metrics import MetricsRegistry as JRegistry
from aiko_services_tpu.serving_paged import BlockPool as JPool
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.observe.metrics import \
    MetricsRegistry as TRegistry
from aiko_services_tpu_torch.serving_paged import BlockPool as TPool

J_CONFIG = JL.LLAMA_PRESETS["tiny"]
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PACKAGES = {"jax": (JS, JPool, J_CONFIG, JRegistry, {}),
            "torch": (TS, TPool, T_CONFIG, TRegistry, {"device": "cpu"})}


def _cache(package, block_bytes_cap=None, tenant_cap=None, int8=False,
           name="c"):
    """(cache, pool, registry) of one package: 4-token blocks, byte
    budgets given in pool blocks."""
    serving, pool_class, config, registry_class, extra = PACKAGES[package]
    registry = registry_class()
    pool = pool_class(config, 4, int8, initial_blocks=8, grow_blocks=8,
                      name=name, registry=registry, **extra)
    cache = serving.PrefixKVCache(
        block_tokens=4,
        max_bytes=None if block_bytes_cap is None
        else block_bytes_cap * pool.block_nbytes,
        tenant_max_bytes=None if tenant_cap is None
        else tenant_cap * pool.block_nbytes,
        name=name, registry=registry)
    cache.attach_pool(pool)
    return cache, pool, registry


def _insert_chain(cache, pool, tenant, tokens):
    """Register `tokens`' chain block by block from fresh pool blocks;
    the caller's alloc refs drop afterwards (cache-held blocks keep one
    ref, refused ones free).  Returns (keys, insert results)."""
    keys = cache.keys_for(tenant, tokens)
    ids = pool.alloc_blocks(len(keys))
    parent, results = "", []
    for key, block_id in zip(keys, ids):
        results.append(cache.insert_block(tenant, parent, key, block_id))
        if not results[-1]:
            break
        parent = key
    pool.release_blocks(ids)
    return keys, results


def _state(cache, pool):
    return {"nodes": [(key, node.refs, node.pool_id, node.parent,
                       sorted(node.children), node.tenant)
                      for key, node in cache._nodes.items()],
            "bytes": cache.bytes_used,
            "tenants": dict(cache._tenant_bytes),
            "sessions": cache.sessions(),
            "used": pool.used_blocks(),
            "stats": {k: v for k, v in cache.stats.items()}}


def _eviction_script(package):
    cache, pool, _ = _cache(package, block_bytes_cap=6, name="evict")
    log = []
    chain_a, results = _insert_chain(cache, pool, "t", list(range(12)))
    log.append((results, _state(cache, pool)))
    # pin chain A under a session handle: it survives any pressure
    log.append((cache.session_store("t", "s1", list(range(12))),
                _state(cache, pool)))
    log.append((_insert_chain(cache, pool, "t",
                              [90 + i for i in range(12)])[1],
                _state(cache, pool)))
    # pressure: a third chain evicts B's leaves, never A's pinned blocks
    log.append((_insert_chain(cache, pool, "t",
                              [60 + i for i in range(12)])[1],
                _state(cache, pool)))
    assert all(key in cache._nodes for key in chain_a)
    for node in cache._nodes.values():
        for child in node.children:
            assert child in cache._nodes, "dangling child"
    log.append((cache.session_release("t", "s1"), _state(cache, pool)))
    log.append((_insert_chain(cache, pool, "t",
                              [30 + i for i in range(12)])[1],
                _state(cache, pool)))
    assert cache.bytes_used <= 6 * pool.block_nbytes
    return log


def _tenant_script(package):
    cache, pool, _ = _cache(package, tenant_cap=2, name="tenants")
    log = [(_insert_chain(cache, pool, "a", list(range(8)))[1],
            _insert_chain(cache, pool, "b", list(range(8)))[1],
            _state(cache, pool))]
    # same tokens, another tenant: other keys, nothing shared
    assert len(cache) == 4
    log.append((cache.match("a", list(range(8))), _state(cache, pool)))
    # tenant a over ITS budget evicts a's blocks only
    log.append((_insert_chain(cache, pool, "a",
                              [50 + i for i in range(8)])[1],
                cache.tenant_bytes("a"), cache.tenant_bytes("b"),
                cache.match("b", list(range(8))), _state(cache, pool)))
    return log


def _pinned_script(package):
    cache, pool, _ = _cache(package, block_bytes_cap=2, name="pinned")
    log = [(_insert_chain(cache, pool, "t", list(range(8)))[1],
            cache.session_store("t", "s", list(range(8))),
            _state(cache, pool))]
    keys = cache.keys_for("t", [70, 71, 72, 73])
    block_id = pool.alloc_blocks(1)[0]
    log.append((cache.insert_block("t", "", keys[0], block_id),
                _state(cache, pool)))
    pool.release_blocks([block_id])
    log.append((cache.match("t", list(range(8))), _state(cache, pool)))
    return log


def _session_script(package):
    cache, pool, registry = _cache(package, block_bytes_cap=64,
                                   name="sessions")
    log = []
    _insert_chain(cache, pool, "t", list(range(16)))
    _insert_chain(cache, pool, "u", list(range(16)))
    tokens = list(range(13))
    log.append((cache.acquire("t", tokens, limit=12), _state(cache, pool)))
    log.append((cache.acquire("t", [5] + tokens), cache.hit_rate(),
                _state(cache, pool)))
    cache.release(cache.keys_for("t", tokens[:12]))
    log.append((cache.session_store("t", "s1", list(range(16))),
                cache.session_store("u", "s2", list(range(9))),
                cache.session_store("", "s3", [1, 2]),
                cache.session_tokens("t", "s1"), _state(cache, pool)))
    # a new handle for s1 replaces (and releases) its old one
    log.append((cache.session_store("t", "s1", list(range(8))),
                _state(cache, pool)))
    # the SessionTable hooks' batch shape; unknown sessions are skipped
    log.append((cache.demote_sessions([("t", "s1"), ("t", "gone")]),
                _state(cache, pool)))
    cache.release_sessions([("u", "s2")])
    log.append((cache.session_release("u", "s2"), _state(cache, pool)))
    cache.session_store("t", "s4", list(range(16)))
    log.append((cache.purge(), _state(cache, pool)))
    assert pool.used_blocks() == 0 and len(cache) == 0
    log.append(registry.value("serving_prefix_hit_tokens_total",
                              {"cache": "sessions", "tenant": "t"})
               if package == "torch" else
               {s["labels"]["tenant"]: s["value"] for s in
                registry.snapshot()["serving_prefix_hit_tokens_total"]
                ["series"]}["t"])
    return log


def test_chain_keys_are_jax_bytes():
    rng = np.random.default_rng(0)
    for tenant in ("", "default", "acme", "tenant-é"):
        for block in (1, 4, 8, 32):
            tokens = rng.integers(0, 128256, int(rng.integers(0, 200)))
            tokens = tokens.tolist()
            assert TS.prefix_chain_keys(tenant, tokens, block) == \
                JS.prefix_chain_keys(tenant, tokens, block)
    keys = TS.prefix_chain_keys("a", list(range(32)), 8)
    assert len(keys) == 4 and len(set(keys)) == 4
    assert TS.prefix_chain_keys("b", list(range(32)), 8)[0] != keys[0]
    assert len(TS.prefix_chain_keys("a", list(range(15)), 8)) == 1


@pytest.mark.parametrize("script", [_eviction_script, _tenant_script,
                                    _pinned_script, _session_script])
def test_cache_scripts_agree_call_for_call(script):
    assert script("torch") == script("jax")


def test_block_geometry_check_agrees():
    layout = (2, 2, 16, "float32", False, 4, 4)
    good = {"k": [np.zeros((2, 4, 16), np.float32)] * 2,
            "v": [np.zeros((2, 4, 16), np.float32)] * 2}
    TS.check_block_geometry(layout, 4, good)
    int8_layout = layout[:4] + (True,) + layout[5:]
    bad = [
        (layout, {"k": good["k"][:1], "v": good["v"]}),
        (layout, {"k": [np.zeros((2, 4, 8), np.float32)] * 2,
                  "v": good["v"]}),
        (int8_layout, good),
        (int8_layout, {"k": [{"q": np.zeros((2, 4, 16), np.int8),
                              "s": np.zeros((2, 5), np.float32)}] * 2,
                       "v": good["v"]}),
    ]
    for bad_layout, entry in bad:
        with pytest.raises(ValueError) as port_error:
            TS.check_block_geometry(bad_layout, 4, entry)
        with pytest.raises(ValueError) as jax_error:
            JS.check_block_geometry(bad_layout, 4, entry)
        assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("int8", [False, True])
def test_pool_copy_install_and_read_agree(int8):
    """write_blocks installs host rows, copy_blocks copies blocks
    (copy-on-extend), block_rows reads one back: the same values in both
    packages' pools, and the same counters."""
    rng = np.random.default_rng(1)
    pools = {}
    for package in PACKAGES:
        _, pool, _ = _cache(package, int8=int8, name=f"rows{int8}")
        pools[package] = pool
    heads, block, dim = (T_CONFIG.num_kv_heads, 4, T_CONFIG.head_dim)

    def layer_rows():
        if int8:
            return {"q": rng.integers(-127, 128, (3, heads, block, dim))
                    .astype(np.int8),
                    "s": rng.random((3, heads, block)).astype(np.float32)}
        return rng.standard_normal((3, heads, block, dim)).astype(np.float32)

    k_rows = [layer_rows() for _ in range(T_CONFIG.num_layers)]
    v_rows = [layer_rows() for _ in range(T_CONFIG.num_layers)]
    for package, pool in pools.items():
        ids = pool.alloc_blocks(5, tenant="t")
        pool.write_blocks(ids[:3], k_rows, v_rows)
        assert pool.copy_blocks(ids[:2], ids[3:]) == 2 * pool.block_nbytes
        pool.release_blocks(ids, tenant="t")
    assert pools["torch"].block_nbytes == pools["jax"].block_nbytes
    for key in ("cow_copies", "cow_copy_bytes", "install_blocks",
                "install_bytes", "allocs", "frees"):
        assert pools["torch"].stats[key] == pools["jax"].stats[key], key

    def as_numpy(leaf):
        if isinstance(leaf, dict):
            return {k: np.asarray(v) for k, v in leaf.items()}
        return np.asarray(leaf)

    for block_id in range(1, 6):
        port_k, port_v = pools["torch"].block_rows(block_id)
        jax_k, jax_v = pools["jax"].block_rows(block_id)
        for port, ref in zip(port_k + port_v, jax_k + jax_v):
            port, ref = as_numpy(port), as_numpy(ref)
            if int8:
                for key in ("q", "s"):
                    np.testing.assert_array_equal(port[key], ref[key])
            else:
                np.testing.assert_array_equal(port, ref)


def test_bind_enforces_one_layout_and_one_pool():
    cache, pool, _ = _cache("torch", name="bind")
    cache.bind((2, 2, 16, "torch.float32", False, 4, 4), paged=True)
    with pytest.raises(ValueError, match="already bound"):
        cache.bind((2, 2, 32, "torch.float32", False, 4, 4), paged=True)
    _, other, _ = _cache("torch", name="bind2")
    with pytest.raises(ValueError, match="already attached"):
        cache.attach_pool(other)
    cache.attach_pool(pool)                  # the same pool: a no-op
    assert cache.pool is pool and cache.paged


@pytest.mark.parametrize("int8", [False, True])
def test_install_chain_matches_jax_call_for_call(int8):
    """Shipped chain blocks installed into both packages' paged caches:
    the same nodes, refs, pool ids and counters after every call, the
    rows landed exactly, a cached prefix counts without a new block, and
    a budget refusal stops the chain."""
    rng = np.random.default_rng(9)
    shape = (J_CONFIG.num_kv_heads, 4, J_CONFIG.head_dim)

    def leaf():
        if int8:
            return {"q": rng.integers(-127, 127, shape, dtype=np.int8),
                    "s": rng.random(shape[:2], np.float32)}
        return rng.standard_normal(shape).astype(np.float32)

    blocks = [{"k": [leaf() for _ in range(J_CONFIG.num_layers)],
               "v": [leaf() for _ in range(J_CONFIG.num_layers)]}
              for _ in range(3)]
    tokens = list(range(1, 14))
    records = {}
    for package in PACKAGES:
        cache, pool, _ = _cache(package, block_bytes_cap=4, int8=int8,
                                name=f"install{int8}")
        layout = (J_CONFIG.num_layers, J_CONFIG.num_kv_heads,
                  J_CONFIG.head_dim, "f32", int8, 4, 4)
        cache.bind(layout, paged=True)
        record = [cache.wire_layout(), cache.layout_compatible(
            [str(f) for f in layout]), cache.layout_compatible(["x"])]
        record.append(cache.install_chain("t", tokens, 0, blocks[:2]))
        record.append(_state(cache, pool))
        # the second call re-ships block 1 and adds block 2: one new
        # pool block, and the budget (4 blocks) still holds
        record.append(cache.install_chain("t", tokens, 1, blocks[1:]))
        record.append(_state(cache, pool))
        keys = cache.keys_for("t", tokens)
        for j, node in enumerate(cache.nodes(keys)):
            k_rows, _ = cache.block_rows(node)
            for i, got in enumerate(k_rows):
                sent = blocks[j]["k"][i]
                for name, plane in (got.items() if int8
                                    else [("", got)]):
                    want = sent[name] if int8 else sent
                    np.testing.assert_array_equal(np.asarray(plane), want)
        # two tenants' chains against a 4-block budget: the second
        # tenant's third block is refused and the chain stops there
        record.append(cache.install_chain("u", tokens, 0, blocks))
        record.append(_state(cache, pool))
        records[package] = record
    assert records["torch"] == records["jax"]
    assert records["torch"][3] == 2 and records["torch"][5] == 2
    assert records["torch"][1] and not records["torch"][2]
