"""The port's serving path (ring KVCache, GenerationServer, HTTP front end)
against the JAX package's, on the same weights.

Configs: the JAX serving tests' ``tiny`` model (block 64, vocab 50, 2
layers, 2 heads, 32 wide, fp32) with a float and an int8 cache, and a
``flat_kv`` GQA int8 variant (2 layers, 4 heads, 256 wide, KH=2). JAX init
weights cross through ``state_dict_from_jax``, with ``wte`` scaled by 10 so
that greedy choices are not near-ties that fp32 summation order could flip.

Tolerances: fp32 logits differ only by accumulation order (XLA vs torch CPU
kernels): 1e-4 absolute (the logits are O(1)-O(10)). Greedy tokens must be
equal. The port's sampled tokens cannot match JAX's threefry draws; there
the port is held to JAX's keep-set (every token JAX draws is one the port
may draw) and to its own determinism contract.
"""

import copy
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.models.gpt import KVCache as JaxKVCache
from ai_music_generation_tpu.serve.engine import (
    GenerationServer as JaxServer,
)
from ai_music_generation_tpu.serve.engine import (
    _per_slot_sample as jax_per_slot_sample,
)
from ai_music_generation_tpu_torch.decode.generate import filter_logits
from ai_music_generation_tpu_torch.models.convert import state_dict_from_jax
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig, KVCache
from ai_music_generation_tpu_torch.serve import engine as port_engine
from ai_music_generation_tpu_torch.serve.engine import (
    GenerationServer,
    gumbel_noise,
    keep_filter,
    noise_bits,
)
from ai_music_generation_tpu_torch.parallel import distributed
from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
from ai_music_generation_tpu_torch.serve.http import EngineRunner, serve

torch.set_num_threads(1)

TINY = dict(block_size=64, vocab_size=50, n_layer=2, n_head=2, n_embd=32,
            dropout=0.0)
VARIANTS = {
    "tiny": dict(TINY),
    "tiny-int8": dict(TINY, kv_quantized=True),
    "gqa-flat-int8": dict(TINY, n_head=4, n_embd=256, n_kv_head=2,
                          flat_kv=True, kv_quantized=True),
}
# the engine settings of every cross-framework serving comparison: a
# 32-column ring (refresh 16) with 8 ticks a call, 12 slots, waves of 16
SERVE = dict(n_slots=12, ticks_per_call=8, cache_len=32, admit_group=16)


def _models(name):
    """(JAX model, params, port model) for a variant, fp32."""
    kw = VARIANTS[name]
    jmodel = JaxGPT(JaxGPTConfig(**kw, dtype=jnp.float32))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32)))
    p = params["params"]
    p["wte"]["embedding"] = np.asarray(p["wte"]["embedding"]) * 10.0
    cfg = GPTConfig(**kw, dtype=torch.float32)
    model = GPT(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def tiny():
    return _models("tiny")


# the requests of the greedy engine comparison: 14 of them for 12 slots
# (a first wave of 12 above 8, later waves below), prompts of 1-20 tokens,
# budgets up to 45 (past the 32-column ring: window refreshes)
PROMPT_LENS = [3, 1, 20, 7, 12, 2, 16, 5, 9, 4, 18, 6, 11, 8]
BUDGETS = [30, 12, 45, 5, 40, 25, 9, 33, 17, 44, 6, 21, 38, 14]
ENCODE = lambda s: [ord(c) % 50 for c in s]  # noqa: E731
DECODE = lambda toks: "".join(chr(65 + (t % 26)) for t in toks)  # noqa: E731
HTTP_PROMPTS = [[1, 2, 3], ENCODE("abc")]  # 30 and 10 greedy tokens


def _requests():
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, 50, n).tolist(), b)
            for n, b in zip(PROMPT_LENS, BUDGETS)]
    return reqs + [(HTTP_PROMPTS[0], 30), (HTTP_PROMPTS[1], 10)]


def _serve_greedy(srv, reqs):
    rids = [srv.submit(p, max_new_tokens=b, temperature=0.0, seed=i)
            for i, (p, b) in enumerate(reqs)]
    done = {r.id: r for r in srv.run_until_idle()}
    return [done[r].generated for r in rids]


@pytest.fixture(scope="module")
def jax_greedy():
    """The JAX GenerationServer's greedy tokens per variant (computed once:
    each JAX server compiles its programs)."""
    out = {}

    def get(name):
        if name not in out:
            jmodel, params, _ = _models(name)
            out[name] = _serve_greedy(JaxServer(jmodel, params, **SERVE),
                                      _requests())
        return out[name]
    return get


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ring_logits_match_jax(name):
    """Ring-mode T=1 steps against JAX ``per_row=True`` on the same
    weights: rows start at staggered lengths (0, 5, 11, 17) over zeroed
    columns, the cursor starts at 20 of 32 and wraps; 14 steps. Logits
    within 1e-4, lengths and cursor equal."""
    jmodel, params, model = _models(name)
    B, S, steps = 4, 32, 14
    lengths = np.array([0, 5, 11, 17], np.int32)
    jcache = JaxKVCache.create(jmodel.config, B, max_len=S, per_row=True)
    jcache = JaxKVCache(jcache.k, jcache.v, jnp.asarray(lengths),
                        jcache.k_scale, jcache.v_scale,
                        jnp.asarray(20, jnp.int32))
    cache = KVCache.create(model.config, B, max_len=S, device="cpu",
                           per_row=True)
    cache.length.copy_(torch.from_numpy(lengths))
    cache.cursor.fill_(20)
    apply = jax.jit(jmodel.apply)
    ids = np.random.default_rng(1).integers(0, 50, (B, steps)).astype(
        np.int32)
    with torch.no_grad():
        for t in range(steps):
            want, _, jcache = apply(params, ids[:, t:t + 1], cache=jcache)
            got, _ = model(torch.from_numpy(ids[:, t:t + 1]), cache=cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jcache.length))
    assert int(cache.cursor) == int(jcache.cursor) == (20 + steps) % S


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_uniform_ring_rows_equal_lockstep(tiny, quantized):
    """Rows that all start at 0 in ring mode read exactly the columns the
    lockstep cache reads: the same logits bit for bit."""
    _, _, model = tiny
    cfg = GPTConfig(**TINY, kv_quantized=quantized, dtype=torch.float32)
    m = GPT(cfg, device="cpu")
    m.load_state_dict(model.state_dict())
    caches = [KVCache.create(cfg, 3, max_len=32, device="cpu", per_row=pr)
              for pr in (False, True)]
    ids = torch.randint(0, 50, (3, 12), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for t in range(12):
            a, _ = m(ids[:, t:t + 1], cache=caches[0])
            b, _ = m(ids[:, t:t + 1], cache=caches[1])
            assert torch.equal(a, b)
    assert caches[1].length.tolist() == [12] * 3


def test_ring_cache_refuses_a_prefill(tiny):
    _, _, model = tiny
    cache = KVCache.create(model.config, 2, max_len=16, device="cpu",
                           per_row=True)
    with pytest.raises(ValueError, match="T=1"):
        model(torch.zeros((2, 3), dtype=torch.int32), cache=cache)
    with pytest.raises(ValueError, match="two different modes"):
        KVCache.create(model.config, 2, device="cpu", per_row=True,
                       spec=True)


@pytest.mark.parametrize("name", ["tiny", "gqa-flat-int8"])
def test_engine_greedy_tokens_match_jax(jax_greedy, name):
    """Greedy requests through the port's engine and the JAX engine: mixed
    prompts and budgets, more requests than slots, admission waves above
    and below 8, window refreshes at cache_len=32: tokens equal per
    request."""
    _, _, model = _models(name)
    got = _serve_greedy(GenerationServer(model, **SERVE), _requests())
    want = jax_greedy(name)
    assert [len(g) for g in got] == [b for _, b in _requests()]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == list(w), f"request {i}"


def test_engine_survives_a_full_window_at_block_size(tiny):
    """At the default cache_len (= block_size 64, refresh 32, 8 ticks a
    call) a request with a 32-token prompt and 32 new tokens passes through
    length 56 without a refresh and finishes on the last tick of a call,
    idle at length 64 = block_size, while the other slot keeps ticking: its
    clipped position embedding (JAX's nn.Embed clips too) keeps the server
    running, and both requests' greedy tokens equal the JAX engine's."""
    jmodel, params, model = tiny
    reqs = [(list(range(32)), 32), ([1, 2, 3, 4, 5], 70)]
    kw = dict(n_slots=2, ticks_per_call=8)
    got = _serve_greedy(GenerationServer(model, **kw), reqs)
    want = _serve_greedy(JaxServer(jmodel, params, **kw), reqs)
    assert [len(g) for g in got] == [32, 70]
    assert [list(w) for w in want] == got


PARAMS = dict(  # per-row temperature, top_k, top_p of the sampler tests
    temperature=[0.7, 1.0, 1.3, 0.9, 0.0, 0.8, 2.0, 0.5],
    top_k=[5, 0, 200, 3, 10, 1, -4, 37],
    top_p=[0.8, 0.9, 1.0, 0.5, 0.95, 0.6, 1.0, 0.3],
)


def test_jax_draws_lie_in_the_port_keep_set():
    """Every token the JAX ``_per_slot_sample`` draws over 256 keys per
    row (2048 draws) lies in the port filter's keep-set; greedy rows draw
    the argmax in both."""
    B, V = 8, 37
    logits = np.random.default_rng(3).standard_normal((B, V)).astype(
        np.float32) * 3
    jp = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    keys = jax.random.split(jax.random.PRNGKey(0), 256 * B).reshape(
        256, B, -1)
    draws = np.asarray(jax.vmap(lambda k: jax_per_slot_sample(
        jnp.asarray(logits), k, jp["temperature"], jp["top_k"],
        jp["top_p"]))(keys))  # [256, B]
    tp = {k: torch.tensor(v) for k, v in PARAMS.items()}
    keep = torch.isfinite(keep_filter(torch.from_numpy(logits),
                                      tp["temperature"], tp["top_k"],
                                      tp["top_p"])).numpy()
    for b in range(B):
        if PARAMS["temperature"][b] == 0.0:
            assert (draws[:, b] == logits[b].argmax()).all()
        else:
            assert keep[b, draws[:, b]].all(), f"row {b}"
    # the filters do filter: some rows keep only part of the vocabulary
    assert not keep[[0, 3, 5, 7]].all(axis=1).any()


@pytest.mark.parametrize("t,k,p", [(0.8, 200, 1.0), (1.3, 5, 1.0),
                                   (0.7, None, 0.9), (1.0, 10, 0.6),
                                   (0.5, 1, 0.3)])
def test_keep_filter_equals_sample_logits_filter(t, k, p):
    """With one set of parameters for every row, the per-row filter keeps
    the tokens (and values) of the lockstep sampler's ``filter_logits``."""
    V = 50
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (16, V)).astype(np.float32) * 2)
    full = lambda x, dt: torch.full((16,), x, dtype=dt)  # noqa: E731
    got = keep_filter(logits, full(t, torch.float32),
                      full(k if k is not None else 0, torch.int32),
                      full(p, torch.float32))
    want = filter_logits(logits, t, k, p if p < 1.0 else None)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    torch.testing.assert_close(got[torch.isfinite(got)],
                               want[torch.isfinite(want)])


def test_mul32_and_noise_bits_are_exact_32_bit_arithmetic():
    """The int64 hash arithmetic equals Python's unbounded integers mod
    2^32, and a row's bits depend on (seed, gen, v) only."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 4096, dtype=np.int64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B1, 1, 0xFFFFFFFF):
        got = port_engine._mul32(torch.from_numpy(x), c).numpy()
        want = np.array([(int(v) * c) % 2**32 for v in x], np.int64)
        np.testing.assert_array_equal(got, want)
    seed = torch.tensor([1, 2**32 - 1, 7, 7])
    gen = torch.tensor([0, 5, 3, 4], dtype=torch.int32)
    bits = noise_bits(seed, gen, 40)
    assert bits.min() >= 0 and bits.max() < 2**32
    for b in range(4):  # alone, in another batch position
        assert torch.equal(noise_bits(seed[b:b + 1], gen[b:b + 1], 40)[0],
                           bits[b])
    assert not torch.equal(bits[2], bits[3])  # gen moves the stream
    assert len(set(bits[0].tolist())) == 40  # a bijection in v
    g = gumbel_noise(seed, gen, 40)
    assert torch.isfinite(g).all() and g.dtype == torch.float32


def test_gumbel_noise_is_standard_gumbel():
    """Over 64k draws the noise has the standard Gumbel mean (Euler's
    0.5772) and variance (pi^2/6) within 2%."""
    seed = torch.arange(1024)
    g = gumbel_noise(seed, torch.zeros(1024, dtype=torch.int32), 64).double()
    assert abs(g.mean().item() - 0.5772) < 0.02
    assert abs(g.var().item() / (np.pi ** 2 / 6) - 1) < 0.02


def test_slot_and_composition_invariance(tiny):
    """A sampled request gives the same tokens crowded among others (in
    slot 0) as alone behind a filler (in slot 1), across refreshes."""
    _, _, model = tiny
    kw = dict(max_new_tokens=40, temperature=0.9, top_k=10, seed=11)
    srv = GenerationServer(model, n_slots=4, ticks_per_call=8, cache_len=32)
    rid = srv.submit([1, 2, 3], **kw)
    srv.submit([9, 9], max_new_tokens=37, seed=44, temperature=1.3)
    srv.submit([4] * 12, max_new_tokens=25, seed=45, top_p=0.8)
    crowded = {r.id: r for r in srv.run_until_idle()}[rid]
    srv2 = GenerationServer(model, n_slots=4, ticks_per_call=8, cache_len=32)
    srv2.submit([5], max_new_tokens=3, temperature=0.0)
    rid2 = srv2.submit([1, 2, 3], **kw)
    alone = {r.id: r for r in srv2.run_until_idle()}[rid2]
    assert crowded.generated == alone.generated
    assert len(set(crowded.generated)) > 1  # it samples


def test_multi_chunk_admission_is_chunking_invariant(tiny):
    """A wave larger than ``admit_group`` splits into chunks; the tokens do
    not depend on the chunking."""
    _, _, model = tiny
    prompts = [[1 + i, 2 + i, 3] for i in range(12)]

    def run(admit_group):
        srv = GenerationServer(model, n_slots=12, ticks_per_call=4,
                               admit_group=admit_group)
        rids = [srv.submit(p, max_new_tokens=9, seed=i)
                for i, p in enumerate(prompts)]
        done = {r.id: r for r in srv.run_until_idle()}
        return [done[r].generated for r in rids]

    assert run(8) == run(64)


def test_stop_token_and_queueing(tiny):
    _, _, model = tiny
    srv = GenerationServer(model, n_slots=2, ticks_per_call=8)
    rids = [srv.submit([1 + i], max_new_tokens=12, seed=i) for i in range(5)]
    done = {r.id: r for r in srv.run_until_idle()}
    assert sorted(done) == sorted(rids)
    assert all(len(done[r].generated) == 12 for r in rids)
    # the stop token ends a request early, and is its last token
    free = GenerationServer(model, n_slots=2, ticks_per_call=8)
    r0 = free.submit([1], max_new_tokens=60, seed=5, temperature=2.0,
                     top_k=0)
    toks = {r.id: r for r in free.run_until_idle()}[r0].generated
    stop = toks[10]
    srv2 = GenerationServer(model, n_slots=2, ticks_per_call=8)
    rs = srv2.submit([1], max_new_tokens=60, seed=5, temperature=2.0,
                     top_k=0, stop_token=stop)
    req = {r.id: r for r in srv2.run_until_idle()}[rs]
    first = toks.index(stop)
    assert req.generated == toks[:first + 1]


def test_large_vocab_unpacked_path():
    """A vocabulary past 14 bits disables the uint16 packing: the three
    downloads give the same contract (greedy equals the lockstep
    Generator)."""
    from ai_music_generation_tpu_torch.decode.generate import Generator

    cfg = GPTConfig(**dict(TINY, vocab_size=16390), dtype=torch.float32)
    model = GPT(cfg, device="cpu").eval()
    torch.manual_seed(0)
    srv = GenerationServer(model, n_slots=2, ticks_per_call=4)
    rid = srv.submit([1, 2, 3], max_new_tokens=10, seed=3, temperature=0.0)
    done = {r.id: r for r in srv.run_until_idle()}
    ref = Generator(model, max_new_tokens=10, temperature=0.0,
                    top_k=None).generate([[1, 2, 3]])[0, 3:]
    assert done[rid].generated == ref.tolist()


def test_cancel(tiny):
    """Cancelling a queued or in-flight request frees capacity and never
    surfaces the cancelled id; survivors are unaffected."""
    _, _, model = tiny
    srv = GenerationServer(model, n_slots=2, ticks_per_call=4)
    keep = srv.submit([1, 2, 3], max_new_tokens=16, seed=11)
    running = srv.submit([4, 5], max_new_tokens=40, seed=22)
    queued = srv.submit([6], max_new_tokens=16, seed=33)
    srv.step()  # admits keep + running; queued waits
    assert srv.cancel(queued)
    assert srv.cancel(running)
    assert not srv.cancel(9999)
    done = {r.id: r for r in srv.run_until_idle()}
    assert set(done) == {keep}
    assert not srv.active.any() and not srv.busy
    srv2 = GenerationServer(model, n_slots=2, ticks_per_call=4)
    rid2 = srv2.submit([1, 2, 3], max_new_tokens=16, seed=11)
    alone = {r.id: r for r in srv2.run_until_idle()}[rid2]
    assert done[keep].generated == alone.generated


def test_submit_rejects_zero_budget_and_bad_ranges(tiny):
    _, _, model = tiny
    srv = GenerationServer(model, n_slots=2, ticks_per_call=4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        srv.submit([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError, match="prompt"):
        srv.submit([], max_new_tokens=4)
    for kw in (dict(max_new_tokens=2**40), dict(top_k=2**31),
               dict(stop_token=-2**40), dict(temperature=float("inf")),
               dict(top_p=0.0), dict(top_p=float("nan"))):
        with pytest.raises(ValueError):
            srv.submit([1, 2], **kw)
    with pytest.raises(ValueError):
        srv.submit([1, 50], max_new_tokens=3)  # token >= vocab
    rid = srv.submit([1, 2], max_new_tokens=3, seed=-1)  # folds into uint32
    done = srv.run_until_idle()
    assert len(done) == 1 and done[0].id == rid and done[0].seed == 2**32 - 1


def test_latency_stats(tiny):
    _, _, model = tiny
    srv = GenerationServer(model, n_slots=4, ticks_per_call=8)
    assert srv.latency_stats() == {"count": 0}
    for i in range(6):
        srv.submit([1, 2, 3], max_new_tokens=5, seed=i)
    done = srv.run_until_idle()
    assert len(done) == 6
    assert all(r.finished_at > r.submitted_at > 0.0 for r in done)
    stats = srv.latency_stats()
    assert stats["count"] == 6
    assert 0.0 < stats["p50_s"] <= stats["p95_s"] <= stats["p99_s"] \
        <= stats["max_s"]
    assert srv.stats["steps"] > 0 and srv.stats["admit_waves"] > 0
    srv.reset_stats()
    assert srv.latency_stats() == {"count": 0} and srv.stats["steps"] == 0


def test_cache_len_validation_and_mesh(tiny):
    """The ring-cache bounds; on a mesh of one process (a group of one over
    gloo) the server serves the unsharded engine's bytes."""
    _, _, model = tiny
    with pytest.raises(ValueError):  # cache_len > block_size
        GenerationServer(model, n_slots=2, ticks_per_call=4, cache_len=128)
    with pytest.raises(ValueError):  # refresh must stay < cache_len
        GenerationServer(model, n_slots=2, ticks_per_call=4, cache_len=16,
                         refresh=16)
    with pytest.raises(ValueError):  # ticks_per_call > default refresh
        GenerationServer(model, n_slots=2, ticks_per_call=16, cache_len=16)
    kw = dict(n_slots=2, ticks_per_call=4, cache_len=32)
    reqs = [([1, 2, 3], dict(max_new_tokens=20, seed=1)),
            ([4, 5], dict(max_new_tokens=9, seed=2, temperature=0.0))]

    def serve(srv):
        ids = [srv.submit(p, **opts) for p, opts in reqs]
        done = {r.id: r.generated for r in srv.run_until_idle()}
        return [done[i] for i in ids]

    want = serve(GenerationServer(model, **kw))
    with distributed.group_of_one("cpu"):
        srv = GenerationServer(copy.deepcopy(model), **kw,
                               mesh=make_mesh(1, 1, "cpu"))
        assert srv.link.controller and srv.link.rows == 2
        assert serve(srv) == want
        srv.shutdown()
    srv = GenerationServer(model, n_slots=2, ticks_per_call=4)
    assert srv.cache_len == 64 and srv.cache.k[0].shape[1] == 64
    assert srv.cache.length.shape == (2,) and srv.cache.cursor.dim() == 0


def test_prewarm_leaves_the_engine_clean(tiny):
    _, _, model = tiny
    srv = GenerationServer(model, n_slots=4, ticks_per_call=4, admit_group=4,
                           cache_len=32)
    srv.prewarm()
    assert not srv.busy and not srv._live and not srv._queue
    assert srv.latency_stats() == {"count": 0}
    rid = srv.submit([1, 2, 3], max_new_tokens=5, seed=11)
    done = srv.run_until_idle()
    assert [r.id for r in done] == [rid] and len(done[0].generated) == 5


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_http_generate_health_and_sse_match_jax(tiny, jax_greedy):
    """/generate (tokens and text prompts), /health and SSE streaming of the
    port's server give the JAX engine's greedy tokens."""
    _, _, model = tiny
    want = jax_greedy("tiny")
    runner = EngineRunner(GenerationServer(
        model, n_slots=2, ticks_per_call=8, cache_len=32))
    httpd = serve(runner, ENCODE, DECODE, port=0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        greedy = dict(temperature=0.0, seed=3)
        with _post(port, {"tokens": [1, 2, 3], "max_new_tokens": 15,
                          **greedy}) as r:
            out = json.loads(r.read())
        assert out["tokens"] == list(want[-2][:15])
        assert out["text"] == DECODE(out["tokens"])
        with _post(port, {"prompt": "abc", "max_new_tokens": 10,
                          **greedy}) as r:
            assert json.loads(r.read())["tokens"] == list(want[-1])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as r:
            health = json.loads(r.read())
        assert health["slots"] == 2 and health["queued"] == 0
        assert health["latency"]["count"] == 2 and "phases" in health
        events = []
        with _post(port, {"tokens": [1, 2, 3], "max_new_tokens": 30,
                          "stream": True, **greedy}) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            events = [json.loads(line[6:]) for line in r
                      if line.startswith(b"data: ")]
        assert events[-1]["done"] is True and len(events) >= 5
        streamed = [t for ev in events[:-1] for t in ev["tokens"]]
        assert all(ev["text"] == DECODE(ev["tokens"]) for ev in events[:-1])
        assert streamed == events[-1]["tokens"] == list(want[-2])
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"tokens": [1, 2, 99]})
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        runner.shutdown()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_runner_engine_crash_fails_waiters(tiny):
    """An exception in engine.step() fails the pending waiters and marks the
    runner dead (reported by /health), instead of hanging them."""
    _, _, model = tiny
    srv = GenerationServer(model, n_slots=2, ticks_per_call=4)

    def boom():
        raise RuntimeError("injected device error")

    srv.step = boom
    runner = EngineRunner(srv)
    rid = runner.submit([1, 2, 3], max_new_tokens=8, seed=1)
    assert runner.wait(rid, timeout=10) is None
    assert "injected device error" in runner.error
    assert "engine_error" in runner.stats()
    with pytest.raises(RuntimeError, match="engine thread dead"):
        runner.submit([1, 2], max_new_tokens=8)
    runner.shutdown()


def test_serve_bench_cli_runs_its_load(capsys, monkeypatch):
    """cli/serve_bench.py drives its two passes on a tiny GQA int8 model on
    the CPU and prints one JSON line; without a card, the default device
    (the card) is refused for either engine (``--engine tunes`` at tiny
    size: tests/test_torch_tunes_serve.py)."""
    from ai_music_generation_tpu_torch.cli import serve_bench

    out = serve_bench.main([
        "--device=cpu", "--n_slots=8", "--requests=12", "--max_new=16",
        "--block_size=64", "--n_layer=1", "--n_head=2", "--n_embd=32",
        "--cache_len=32", "--ticks_per_call=8", "--kv_quantized",
        "--n_kv_head=1", "--flat_kv"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    assert out["requests"] == 12 and 12 * 8 <= out["gen_tokens"] <= 12 * 16
    assert out["device"] == "cpu" and out["latency"]["count"] == 12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("gpt", "tunes"):
        with pytest.raises(RuntimeError, match="--device=cpu"):
            serve_bench.main([f"--engine={engine}"])
