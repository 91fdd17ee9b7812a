"""The port's TunesFormer server (serve/tunes_engine.py), its HTTP handler
(serve/http.py), cli/serve_tunesformer.py and cli/serve_bench.py --engine
tunes, against the JAX package's on the same weights.

Config: the JAX tests' ``TINY_CFG`` (patch_length 16, patch_size 16, 2+2
layers, 32 wide, 2 heads, fp32), JAX init weights through
``tunesformer_state_dict_from_jax``. Texts per request must equal JAX's at
``top_k=1`` (deterministic in both frameworks); sampled requests hold the
port's own contract: a request's text depends only on its own fields, not
on its slot, the ring cursor or other traffic.
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

from ai_music_generation_tpu.models.tunesformer import (
    TunesFormer as JaxTunesFormer,
)
from ai_music_generation_tpu.models.tunesformer import (
    TunesFormerConfig as JaxConfig,
)
from ai_music_generation_tpu.serve import tunes_engine as jax_engine
from ai_music_generation_tpu.serve.tunes_engine import (
    TunesServer as JaxTunesServer,
)
from ai_music_generation_tpu_torch.cli import serve_bench, serve_tunesformer
from ai_music_generation_tpu_torch.models.convert import (
    init_tunesformer_weights,
    tunesformer_state_dict_from_jax,
)
from ai_music_generation_tpu_torch.models.tunesformer import (
    TunesFormer,
    TunesFormerConfig,
)
from ai_music_generation_tpu_torch.models.tunesformer_export import (
    save_reference_checkpoint,
)
from ai_music_generation_tpu_torch.serve import tunes_engine
from ai_music_generation_tpu_torch.parallel import distributed
from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
from ai_music_generation_tpu_torch.serve.http import EngineRunner, serve_tunes
from ai_music_generation_tpu_torch.serve.tunes_engine import (
    TunesServer,
    sample_ptk_vec,
    tunes_noise_bits,
)

torch.set_num_threads(1)

TINY = dict(patch_length=16, patch_size=16, patch_layers=2, char_layers=2,
            n_embd=32, n_head=2, dropout=0.0)
ABC = "S:1\nB:2\nL:1/8\nM:4/4\nK:C\nCDEF GABc|cBAG FEDC|"
CAPACITY = "K:C\n" + "ab|" * 20  # more than patch_length patches


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**TINY, dtype=jnp.float32)
    jmodel = JaxTunesFormer(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 16, 16), jnp.int32)))
    cfg = TunesFormerConfig(**TINY, dtype=torch.float32)
    model = TunesFormer(cfg, device="cpu")
    model.load_state_dict(tunesformer_state_dict_from_jax(params, cfg))
    return jmodel, params, model.eval()


def _drive(srv):
    """Staggered admissions into 2 slots (5 requests: queueing and slot
    reuse) with mixed settings at top_k=1, a capacity prompt first: after
    its one bar its row idles at length patch_length (a position past the
    position table, clipped) while another request runs, and a late request
    reuses its slot. Returns the texts in submission order."""
    rids = [srv.submit(CAPACITY, max_patch=30, seed=1, top_k=1),
            srv.submit("L:1/8\nK:D\nde fg|", max_patch=12, seed=22,
                       temperature=0.9, top_k=1)]
    done = {r.id: r.text for r in srv.step()}
    assert rids[0] in done  # the capacity prompt ends after its first bar
    done.update({r.id: r.text for r in srv.step()})
    rids += [srv.submit(ABC, max_patch=10, seed=11, top_k=1),
             srv.submit("L:1/4\nK:G\nGA|", max_patch=6, seed=33, top_k=1,
                        show_control_code=False),
             srv.submit(ABC, max_patch=9, seed=44, top_p=0.5, top_k=1)]
    done.update({r.id: r.text for r in srv.run_until_idle()})
    return [done[r] for r in rids]


def test_server_texts_equal_jax_at_top_k_1(models):
    """Per request, the port's server gives the JAX server's text; the
    capacity prompt's row really idled at length patch_length (the ring
    position past ``wpe`` is clipped, as JAX's gather clips)."""
    jmodel, params, model = models
    want = _drive(JaxTunesServer(jmodel, params, n_slots=2))
    srv = TunesServer(model, n_slots=2)
    seen = []
    bar = srv._bar

    def watch(packed):
        seen.append(srv._patch_cache.length.tolist())
        return bar(packed)

    srv._bar = watch
    got = _drive(srv)
    assert got == want
    assert got[0] == CAPACITY and len(got[1]) > len("L:1/8\nK:D\nde fg|")
    assert seen[1][0] == 16  # the idle capacity row, at patch_length


def test_request_text_does_not_depend_on_slot_cursor_or_traffic(models):
    """Sampled (top_p 0.8, top_k 8, T 1.2): a request alone in slot 0, then
    again in slot 1 behind a filler (the ring cursor elsewhere), then among
    other requests admitted later: the same text."""
    _, _, model = models
    srv = TunesServer(model, n_slots=3)
    texts = []
    rid = srv.submit(ABC, max_patch=12, seed=7)
    texts.append({r.id: r for r in srv.run_until_idle()}[rid].text)
    srv.submit("L:1/8\nK:D\nde|", max_patch=12, seed=8)
    rid = srv.submit(ABC, max_patch=12, seed=7)
    texts.append({r.id: r for r in srv.run_until_idle()}[rid].text)
    srv.submit("L:1/4\nK:G\nGA|", max_patch=14, seed=9, top_k=3)
    srv.step()
    srv.submit("K:C\nc|", max_patch=9, seed=10, temperature=0.7)
    rid = srv.submit(ABC, max_patch=12, seed=7)
    texts.append({r.id: r for r in srv.run_until_idle()}[rid].text)
    assert texts[0] == texts[1] == texts[2]
    assert texts[0].startswith(ABC) and len(texts[0]) > len(ABC)


def test_same_seed_same_text_other_seed_other_text(models):
    _, _, model = models
    srv = TunesServer(model, n_slots=2)
    rids = [srv.submit(ABC, max_patch=12, seed=s) for s in (5, 5, 7, 9, 5)]
    done = {r.id: r.text for r in srv.run_until_idle()}
    texts = [done[r] for r in rids]
    assert texts[0] == texts[1] == texts[4]
    assert len(set(texts)) == 3


def test_control_codes_are_display_only(models):
    _, _, model = models
    srv = TunesServer(model, n_slots=1)
    show = srv.submit(ABC, max_patch=12, seed=3, show_control_code=True)
    hide = srv.submit(ABC, max_patch=12, seed=3, show_control_code=False)
    done = {r.id: r.text for r in srv.run_until_idle()}
    strip = "".join(line for line in done[show].splitlines(keepends=True)
                    if line[:2] not in ("S:", "B:", "E:"))
    assert "S:1" in done[show] and strip == done[hide]
    assert len(done[show]) > len(ABC)


@pytest.mark.parametrize("top_k", [8, 0, 1])
def test_sampling_filter_equals_jax_per_row(monkeypatch, top_k):
    """The per-row distribution the port draws from equals the one JAX's
    ``sample_ptk_vec`` hands ``jax.random.categorical`` (captured through
    its vmap), within 1e-6, for per-row top_p / top_k / temperature."""
    rng = np.random.default_rng(top_k)
    logits = rng.standard_normal((4, 128)).astype(np.float32) * 2
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top_p = np.asarray([0.8, 1.0, 0.3, 0.95], np.float32)
    tks = np.asarray([top_k, 0, top_k, 3], np.int32)
    temp = np.asarray([1.2, 1.0, 0.5, 3.0], np.float32)
    seen = {}
    vmap = jax.vmap

    def capture(fn):
        def wrapped(keys, logp):
            seen["jax"] = np.asarray(logp)
            return vmap(fn)(keys, logp)
        return wrapped

    monkeypatch.setattr(jax, "vmap", capture)
    jax_engine.sample_ptk_vec(
        jnp.asarray(probs), jax.random.split(jax.random.PRNGKey(0), 4),
        jnp.asarray(top_p), jnp.asarray(tks), jnp.asarray(temp))
    monkeypatch.undo()
    draw = tunes_engine.draw

    def capture_draw(filtered, sorted_idx, noise):
        seen["port"] = filtered
        return draw(filtered, sorted_idx, noise)

    monkeypatch.setattr(tunes_engine, "draw", capture_draw)
    z = torch.zeros(4, dtype=torch.int64)
    sample_ptk_vec(torch.from_numpy(probs), z, z, z, torch.from_numpy(top_p),
                   torch.from_numpy(tks), torch.from_numpy(temp))
    filtered = seen["port"]
    mine = (filtered / filtered.sum(-1, keepdim=True)).numpy()
    want = np.asarray(jax.nn.softmax(jnp.asarray(seen["jax"]), axis=-1))
    np.testing.assert_allclose(mine, want, atol=1e-6, rtol=0)


def test_noise_is_a_function_of_seed_bar_and_index():
    seed = torch.tensor([7, 7, 7, 8, 2**32 - 1], dtype=torch.int64)
    bar = torch.tensor([0, 0, 1, 0, 3], dtype=torch.int32)
    idx = torch.tensor([0, 0, 0, 0, 31], dtype=torch.int32)
    bits = tunes_noise_bits(seed, bar, idx, 128)
    assert bits.dtype == torch.int64 and bits.shape == (5, 128)
    assert ((bits >= 0) & (bits < 2**32)).all()
    assert torch.equal(bits[0], bits[1])
    assert not torch.equal(bits[0], bits[2])
    assert not torch.equal(bits[0], bits[3])
    assert len(set(bits[0].tolist())) == 128
    assert torch.equal(tunes_noise_bits(seed[4:], bar[4:], idx[4:], 128),
                       bits[4:])


def test_cancel(models):
    _, _, model = models
    srv = TunesServer(model, n_slots=1)
    keep = srv.submit(ABC, max_patch=8, seed=3)
    queued = srv.submit(ABC, max_patch=8, seed=4)
    finished = list(srv.step())
    assert srv.cancel(queued)
    assert not srv.cancel(12345)
    finished += srv.run_until_idle()
    assert {r.id for r in finished} == {keep}
    running = srv.submit(ABC, max_patch=12, seed=5)
    srv.step()
    assert srv.cancel(running)
    assert srv.run_until_idle() == [] and not srv.busy


def test_prewarm_leaves_the_server_empty(models):
    _, _, model = models
    srv = TunesServer(model, n_slots=2)
    srv.prewarm()
    assert not srv.busy and not srv._live and not srv._queue
    assert srv.latency_stats() == {"count": 0}
    assert srv.stats["steps"] == 0
    rid = srv.submit("K:C\nab|", max_patch=3, seed=5)
    assert [r.id for r in srv.run_until_idle()] == [rid]


def test_submit_validation_and_mesh(models):
    """Bad submissions raise; on a mesh of one process (a group of one over
    gloo) the server writes the unsharded server's text."""
    _, _, model = models
    srv = TunesServer(model, n_slots=1)
    for bad in (dict(prompt=""), dict(prompt="K:C\n", max_patch=0),
                dict(prompt="K:C\n", top_k=2**31),
                dict(prompt="K:C\n", top_p=float("nan")),
                dict(prompt="K:C\n", temperature=float("inf"))):
        with pytest.raises(ValueError):
            srv.submit(**bad)
    rid = srv.submit("K:C\n", seed=-1)
    assert srv._live[rid].seed == 2**32 - 1
    want = _one_tune(TunesServer(model, n_slots=2))
    with distributed.group_of_one("cpu"):
        srv = TunesServer(copy.deepcopy(model), n_slots=2,
                          mesh=make_mesh(1, 1, "cpu"))
        assert srv.link.controller and srv.link.rows == 2
        assert _one_tune(srv) == want
        srv.shutdown()


def _one_tune(srv):
    rid = srv.submit(ABC, max_patch=5, seed=3, top_p=0.7)
    return {r.id: r.text for r in srv.run_until_idle()}[rid]


def _post(url, payload):
    req = urllib.request.Request(f"{url}/generate",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def test_tunes_http_handler(models):
    """ABC text in, text out; seeded requests repeat; the text equals the
    JAX server's at top_k=1; a streamed request is refused; /health."""
    jmodel, params, model = models
    jsrv = JaxTunesServer(jmodel, params, n_slots=1)
    jrid = jsrv.submit(ABC, max_patch=8, seed=3, top_k=1)
    want = {r.id: r.text for r in jsrv.run_until_idle()}[jrid]
    runner = EngineRunner(TunesServer(model, n_slots=2))
    httpd = serve_tunes(runner, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        out = _post(url, {"prompt": ABC, "max_patch": 8, "seed": 3,
                          "top_k": 1})
        assert out["text"] == want
        a = _post(url, {"prompt": ABC, "max_patch": 8, "seed": 4})
        assert _post(url, {"prompt": ABC, "max_patch": 8, "seed": 4}) == \
            dict(a, id=a["id"] + 1)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, {"prompt": ABC, "stream": True})
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, {"prompt": ""})
        assert err.value.code == 400
        with urllib.request.urlopen(f"{url}/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health["slots"] == 2 and health["latency"]["count"] == 3
        assert health["phases"]["steps"] > 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        runner.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_serve_tunesformer_cli_serves_a_weights_pth(tmp_path):
    """cli/serve_tunesformer.py's server over ``<weights>/weights.pth``
    (reference-compatible small widths: 12 heads, 128 patches) on the CPU:
    its text equals the TunesServer's on the same weights."""
    cfg = TunesFormerConfig(patch_length=128, patch_size=8, patch_layers=1,
                            char_layers=1, n_embd=48, n_head=12, dropout=0.0)
    model = init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                     torch.Generator().manual_seed(1)).eval()
    save_reference_checkpoint(str(tmp_path / "weights.pth"), model)
    c = dict(serve_tunesformer.DEFAULTS, weights=str(tmp_path), port=0,
             n_slots=2, device="cpu", prewarm=True)
    runner, httpd = serve_tunesformer.build_server(c)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        out = _post(f"http://127.0.0.1:{httpd.server_address[1]}",
                    {"prompt": "K:C\nab|", "max_patch": 6, "seed": 2})
    finally:
        httpd.shutdown()
        httpd.server_close()
        runner.shutdown()
        thread.join(timeout=30)
    srv = TunesServer(model, n_slots=2)
    rid = srv.submit("K:C\nab|", max_patch=6, seed=2)
    assert out["text"] == {r.id: r for r in srv.run_until_idle()}[rid].text


def test_serve_bench_tunes_at_tiny_size(capsys, monkeypatch):
    """``cli/serve_bench.py --engine tunes`` drives its warm and timed
    passes on the CPU (its config shrunk to tiny widths) and prints one
    JSON line."""
    monkeypatch.setattr(serve_bench, "TUNES_CONFIG", TunesFormerConfig(
        patch_length=16, patch_size=16, patch_layers=1, char_layers=1,
        n_embd=32, n_head=2, dropout=0.0, dtype=torch.float32))
    out = serve_bench.main([
        "--engine=tunes", "--device=cpu", "--n_slots=4", "--requests=6",
        "--max_patch=12"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    assert out["metric"] == "tunesformer_serve_throughput"
    assert out["unit"] == "tunes/min" and out["value"] > 0
    assert out["requests"] == 6 and out["latency"]["count"] == 6
    assert out["device"] == "cpu" and out["gen_chars"] > 0
