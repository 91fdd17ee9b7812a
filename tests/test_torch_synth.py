"""The port's synth (``ai_music_generation_tpu_torch/synth/render.py``)
against the JAX package's on the CPU: the same events through both renders.

The waves are held to JAX's within a share of their range: XLA and torch
compute ``exp`` (the release and decay) and ``sin`` (the additive voice)
with other fp32 polynomials, an ulp apart. Everything that decides an index
is computed as XLA compiles it (``x / c`` as ``x * (1 / c)``, ``2 ** x``
rounded from float64, which equals XLA's fp32 ``pow`` on every integer
offset), so the zone choice, the gather positions, the note-off masks and
the trim indices are equal. Measured: sample bank and sf2 below 2e-7 of
the range, additive below 1e-7 (the phase ``(2 pi f_h) t`` reaches 2e5
rad, where an ulp of ``f_h`` would move it by 1e-2: its bits are equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ai_music_generation_tpu.abcnotation.to_midi import abc_to_midi as jax_abc_to_midi
from ai_music_generation_tpu.codec import midi_io as jax_midi_io
from ai_music_generation_tpu.synth import render as jax_render
from ai_music_generation_tpu_torch.abcnotation.to_midi import abc_to_midi
from ai_music_generation_tpu_torch.cli.random_baselines import random_tunes
from ai_music_generation_tpu_torch.codec import midi_io
from ai_music_generation_tpu_torch.synth import render
from ai_music_generation_tpu_torch.synth.sf2 import write_sf2

torch.set_num_threads(1)

SR = 16_000
RANGE_FRAC = 1e-5  # of the wave's range, every voice (measured <= 2e-7)


def _sine(freq, seconds=0.3, rate=SR, amp=0.8):
    t = np.arange(int(seconds * rate)) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.fixture(scope="module")
def sf2_voice(tmp_path_factory):
    """tests/test_sf2.py:25's two-zone font, plus a second velocity layer on
    the low zone (two zones share a key range, split by velocity)."""
    path = str(tmp_path_factory.mktemp("sf2") / "tiny.sf2")
    write_sf2(path, [
        dict(wave=_sine(220.0), root=57, key_range=(0, 63),
             vel_range=(0, 63), loop=(800, 4000), release_tc=-3600,
             fine_tune=0),
        dict(wave=_sine(330.0), root=57, key_range=(0, 63),
             vel_range=(64, 127), release_tc=-2400),
        dict(wave=_sine(880.0), root=81, key_range=(64, 127),
             vel_range=(0, 127), attack_tc=-7200, sustain_cb=200,
             atten_cb=60),
    ], preset_name="TestPiano")
    return f"sf2:{path}"


def crafted_events(total, seed=0, n=24):
    """Overlapping notes, a start past ``total``, a pitch halfway between
    two bank roots (24: roots 21 and 27), both velocity layers, and random
    notes."""
    rng = np.random.default_rng(seed)
    ev = np.stack([
        rng.integers(28, 100, n).astype(np.float32),
        rng.uniform(0, 0.8 * total, n).astype(np.float32),
        rng.uniform(0.05 * SR, 1.5 * SR, n).astype(np.float32),
        rng.uniform(0.1, 1.0, n).astype(np.float32),
    ], 1)
    ev[:6] = [
        [24.0, 100.5, 8000.0, 0.7],          # zone tie
        [60.0, total + 500.0, 4000.0, 0.5],  # starts past the end
        [62.0, 1000.0, 30000.0, 0.3],        # overlaps the next two
        [66.0, 1200.7, 20000.0, 0.9],
        [40.0, 1500.0, 12000.0, 0.45],       # low velocity layer
        [40.0, total - 300.0, 9000.0, 0.55], # runs past the end
    ]
    return ev


def _voices(sf2_voice):
    return {"sample_bank": "sample_bank", "additive": "additive",
            "sf2": sf2_voice}


def _range_err(got, want):
    return float(np.abs(got - want).max() / (want.max() - want.min()))


@pytest.mark.parametrize("voice", ["sample_bank", "additive", "sf2"])
@pytest.mark.parametrize("seconds,seed", [(2, 0), (4, 1)])
def test_render_events_matches_jax(sf2_voice, voice, seconds, seed):
    voice = _voices(sf2_voice)[voice]
    total = seconds * SR
    ev = crafted_events(total, seed)
    want = np.asarray(jax_render.render_events(jnp.asarray(ev), total, SR,
                                               voice))
    got = render.render_events(ev, total, SR, voice, device="cpu").numpy()
    assert got.shape == want.shape == (total,) and got.dtype == np.float32
    assert _range_err(got, want) <= RANGE_FRAC
    assert int(render.trim_trailing_silence(torch.from_numpy(got))) == \
        int(jax_render.trim_trailing_silence(jnp.asarray(want)))


def test_zone_tie_takes_the_first_root():
    """Pitch 24 is 3 semitones from roots 21 and 27: argmin takes the first
    (21), as jnp.argmin does; 25 takes 27."""
    root, key_r, vel_r = (torch.as_tensor(a) for a in
                          render._voice_bank("sample_bank", SR)[1:4])
    assert root[:2].tolist() == [21.0, 27.0]
    pitch = torch.tensor([[24.0, 25.0, 23.0]])
    k = render._zones(pitch, torch.full_like(pitch, 0.5), root, key_r, vel_r)
    assert k.tolist() == [[0, 1, 0]]


@pytest.mark.parametrize("voice", ["sample_bank", "additive", "sf2"])
def test_render_events_batch_equals_stacked_render_events(sf2_voice, voice):
    """Rows of different lengths (the shorter padded with silent events)
    render to the bits each renders alone."""
    voice = _voices(sf2_voice)[voice]
    total = 2 * SR
    rows = [crafted_events(total, seed, n) for seed, n in
            ((0, 24), (1, 9), (2, 17))]
    batch = np.zeros((3, 24, 4), np.float32)
    for i, ev in enumerate(rows):
        batch[i, :len(ev)] = ev
    got = render.render_events_batch(batch, total, SR, voice, device="cpu")
    for i, ev in enumerate(rows):
        alone = render.render_events(ev, total, SR, voice, device="cpu")
        assert torch.equal(got[i], alone), i


def test_chunks_do_not_change_the_bits(monkeypatch):
    """The segments are built a chunk of notes at a time: the chunk size
    changes no bit (each note's window is added in event order)."""
    total = 2 * SR
    ev = crafted_events(total, 3)
    whole = render.render_events(ev, total, SR, device="cpu")
    monkeypatch.setattr(render, "SEGMENT_ELEMENTS", 5 * 4 * SR)
    assert torch.equal(render.render_events(ev, total, SR, device="cpu"),
                       whole)


def _empty(mod=midi_io):
    return mod.MidiFile(480, [], [], [], [])


def _midis(n=3, seed=5):
    return [abc_to_midi(t) for t in random_tunes(n, seed)]


def test_midi_to_events_equals_jax():
    """Exact, over random-baseline tunes and a tempo map with two changes."""
    midis = _midis(4)
    tempo = midis[0]
    tempo.tempos = [midi_io.TempoEvent(0, 500000),
                    midi_io.TempoEvent(960, 250000),
                    midi_io.TempoEvent(2880, 750000)]
    for m in midis:
        jm = jax_midi_io.parse_midi_bytes(midi_io.write_midi_bytes(m))
        got = render.midi_to_events(m)
        want = jax_render.midi_to_events(jm)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("voice", ["sample_bank", "additive"])
def test_synthesize_midi_batch_matches_jax(voice):
    """Lengths equal (the trim index and the need), waves within the
    render's tolerance; an empty MIDI gives zeros(0) on both sides."""
    tunes = random_tunes(2, 8)
    midis = [abc_to_midi(t) for t in tunes] + [_empty()]
    jax_midis = [jax_abc_to_midi(t) for t in tunes] + [_empty(jax_midi_io)]
    got = render.synthesize_midi_batch(midis, SR, max_seconds=4.0,
                                       voice=voice, device="cpu")
    want = jax_render.synthesize_midi_batch(jax_midis, SR, max_seconds=4.0,
                                            voice=voice)
    assert [len(w) for w in got] == [len(w) for w in want]
    assert len(got[-1]) == 0 and got[-1].dtype == np.float32
    for g, w in zip(got[:-1], want[:-1]):
        assert _range_err(g, w) <= RANGE_FRAC


def test_synthesize_midi_matches_jax():
    m = _midis(1, 9)[0]
    jm = jax_abc_to_midi(random_tunes(1, 9)[0])
    got = render.synthesize_midi(m, SR, max_seconds=3.0, device="cpu")
    want = jax_render.synthesize_midi(jm, SR, max_seconds=3.0)
    assert got.shape == want.shape
    assert _range_err(got, want) <= RANGE_FRAC
    # the batch path trims the same wave to the same length
    assert len(render.synthesize_midi_batch([m], SR, max_seconds=3.0,
                                            device="cpu")[0]) == len(got)


def test_empty_midi_gives_zeros():
    for got in (render.synthesize_midi(_empty(), device="cpu"),
                *render.synthesize_midi_batch([_empty()] * 2,
                                              device="cpu")):
        assert got.shape == (0,) and got.dtype == np.float32


def test_mesh_raises_naming_item_6():
    """The render over a mesh of one process (a group of one over gloo) is
    bit-equal to the unsharded render (the multi-rank render:
    tests/test_torch_serve_mesh.py)."""
    from ai_music_generation_tpu_torch.parallel import distributed
    from ai_music_generation_tpu_torch.parallel.mesh import make_mesh

    midis = _midis(2)
    want = render.synthesize_midi_batch(midis, device="cpu")
    with distributed.group_of_one("cpu"):
        got = render.synthesize_midi_batch(
            midis, mesh=make_mesh(1, 1, "cpu"), device="cpu")
    assert len(got) == 2 and all(np.array_equal(g, w)
                                 for g, w in zip(got, want))


def test_cuda_without_a_card_raises(monkeypatch):
    """The render never carries on on the CPU when asked for the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render.render_events(crafted_events(SR), SR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render.synthesize_midi_batch(_midis(1))
