"""SoundFont 2 (.sf2) ingestion -> sample-bank tensors for the synth.

The port's copy of ``ai_music_generation_tpu/synth/sf2.py`` (the port
imports nothing of the JAX package; tests/test_torch_host_copies.py holds
the two to each other).

The reference's timbre comes from FluidSynth loading
"Essential Keys-sforzando-v9.6.sf2"
(ref: scripts/common/midi_to_wav_and_aesthetics.py:105-110, README.md:18-25).
This module parses the SF2 RIFF container directly — sample data, key/velocity
ranges, root keys + tuning, loop points, volume-envelope generators — and
bakes each zone into the render-ready tensor format of
``synth/render.py``'s sample-bank voice: rows of fixed-length float32 audio
(attack/hold/decay envelope applied, loop-extended to the row length) plus
per-row root pitch, key range, velocity range, and release time-constant.
Playback then stays the sample-bank path of ``synth/render.py``: one
gather + linear-interp pitch shift per note.

Scope (documented subset of the SF2 2.04 spec): instrument-level zones with
their global-zone defaults; preset-level zones select instruments and
intersect key/velocity ranges. Modulators (pmod/imod), filter/pitch
envelopes, LFOs, and chorus/reverb sends are ignored — the reference
pipeline renders dry piano at 16 kHz where the volume envelope dominates.
A minimal writer (:func:`write_sf2`) produces structurally valid fixtures so
the parser is testable without shipping a licensed soundfont.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

# generator opcodes (SF2 spec §8.1.2)
GEN_START_ADDR_OFS = 0
GEN_END_ADDR_OFS = 1
GEN_STARTLOOP_OFS = 2
GEN_ENDLOOP_OFS = 3
GEN_INITIAL_ATTEN = 48
GEN_COARSE_TUNE = 51
GEN_FINE_TUNE = 52
GEN_SAMPLE_ID = 53
GEN_SAMPLE_MODES = 54
GEN_OVERRIDE_ROOT = 58
GEN_KEY_RANGE = 43
GEN_VEL_RANGE = 44
GEN_INSTRUMENT = 41
GEN_ATTACK = 34
GEN_HOLD = 35
GEN_DECAY = 36
GEN_SUSTAIN = 37
GEN_RELEASE = 38


@dataclasses.dataclass
class Sf2Sample:
    name: str
    start: int
    end: int
    start_loop: int
    end_loop: int
    sample_rate: int
    original_pitch: int
    pitch_correction: int  # cents
    sample_type: int


@dataclasses.dataclass
class Sf2Zone:
    """One playable instrument zone with inherited generator values."""

    sample: Sf2Sample
    key_lo: int = 0
    key_hi: int = 127
    vel_lo: int = 0
    vel_hi: int = 127
    root: Optional[int] = None  # overridingRootKey
    start_ofs: int = 0  # sample-address offset generators (spec 0-3):
    end_ofs: int = 0  # fine per-zone shifts of the sample/loop window
    startloop_ofs: int = 0
    endloop_ofs: int = 0
    coarse_tune: int = 0  # semitones
    fine_tune: int = 0  # cents
    atten_cb: int = 0  # initialAttenuation, centibels
    loop: bool = False
    attack_tc: int = -12000  # timecents
    hold_tc: int = -12000
    decay_tc: int = -12000
    sustain_cb: int = 0
    release_tc: int = -12000

    @property
    def root_pitch(self) -> float:
        """Effective root in (possibly fractional) MIDI units: playing this
        zone at ``root_pitch`` reproduces the sample at its recorded rate."""
        root = self.root if self.root is not None else self.sample.original_pitch
        cents = self.sample.pitch_correction + self.fine_tune
        return root - self.coarse_tune - cents / 100.0


@dataclasses.dataclass
class Sf2Preset:
    name: str
    bank: int
    program: int
    zones: list  # list[Sf2Zone]


@dataclasses.dataclass
class Sf2File:
    presets: list  # list[Sf2Preset]
    sample_data: np.ndarray  # float32 [-1, 1)


def _timecents_to_seconds(tc: int) -> float:
    if tc <= -12000:
        return 0.0
    return float(2.0 ** (tc / 1200.0))


def _centibels_to_gain(cb: float) -> float:
    """cB attenuation -> linear gain (10 cB = 1 dB)."""
    return float(10.0 ** (-cb / 200.0))


# ------------------------------------------------------------------ parsing


def _iter_chunks(buf: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        cid = buf[pos:pos + 4]
        size = struct.unpack_from("<I", buf, pos + 4)[0]
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)


def parse_sf2(path: str) -> Sf2File:
    """Parse an .sf2 file into presets of inherited zones + sample data."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"sfbk":
        raise ValueError(f"{path}: not a RIFF sfbk (SoundFont) file")

    smpl = b""
    hydra: dict = {}
    for cid, off, size in _iter_chunks(buf, 12, len(buf)):
        if cid != b"LIST":
            continue
        kind = buf[off:off + 4]
        for sub_id, s_off, s_size in _iter_chunks(buf, off + 4, off + size):
            if kind == b"sdta" and sub_id == b"smpl":
                smpl = buf[s_off:s_off + s_size]
            elif kind == b"pdta":
                hydra[sub_id.decode("latin1").strip()] = buf[s_off:s_off + s_size]

    for need in ("phdr", "pbag", "pgen", "inst", "ibag", "igen", "shdr"):
        if need not in hydra:
            raise ValueError(f"{path}: missing pdta sub-chunk '{need}'")

    samples16 = np.frombuffer(smpl, dtype="<i2")
    sample_data = samples16.astype(np.float32) / 32768.0

    shdr = []
    raw = hydra["shdr"]
    for i in range(len(raw) // 46):
        (name, start, end, sloop, eloop, rate, pitch, corr, _link, stype
         ) = struct.unpack_from("<20sIIIIIBbHH", raw, i * 46)
        shdr.append(Sf2Sample(
            name.split(b"\0")[0].decode("latin1"), start, end, sloop, eloop,
            rate, pitch, corr, stype))
    if shdr:
        shdr = shdr[:-1]  # terminal EOS record

    def read_bags(tag):
        raw = hydra[tag]
        return [struct.unpack_from("<HH", raw, i * 4)
                for i in range(len(raw) // 4)]

    def read_gens(tag):
        raw = hydra[tag]
        return [struct.unpack_from("<Hh", raw, i * 4)
                for i in range(len(raw) // 4)]

    ibag, igen = read_bags("ibag"), read_gens("igen")
    pbag, pgen = read_bags("pbag"), read_gens("pgen")

    insts = []
    raw = hydra["inst"]
    for i in range(len(raw) // 22):
        name, bag_ndx = struct.unpack_from("<20sH", raw, i * 22)
        insts.append((name.split(b"\0")[0].decode("latin1"), bag_ndx))

    def _apply_gen(zone: Sf2Zone, oper: int, amount: int) -> None:
        if oper == GEN_START_ADDR_OFS:
            zone.start_ofs = amount
        elif oper == GEN_END_ADDR_OFS:
            zone.end_ofs = amount
        elif oper == GEN_STARTLOOP_OFS:
            zone.startloop_ofs = amount
        elif oper == GEN_ENDLOOP_OFS:
            zone.endloop_ofs = amount
        elif oper == GEN_KEY_RANGE:
            zone.key_lo, zone.key_hi = amount & 0xFF, (amount >> 8) & 0xFF
        elif oper == GEN_VEL_RANGE:
            zone.vel_lo, zone.vel_hi = amount & 0xFF, (amount >> 8) & 0xFF
        elif oper == GEN_OVERRIDE_ROOT:
            zone.root = amount
        elif oper == GEN_COARSE_TUNE:
            zone.coarse_tune = amount
        elif oper == GEN_FINE_TUNE:
            zone.fine_tune = amount
        elif oper == GEN_INITIAL_ATTEN:
            zone.atten_cb = amount
        elif oper == GEN_SAMPLE_MODES:
            zone.loop = bool(amount & 1)
        elif oper == GEN_ATTACK:
            zone.attack_tc = amount
        elif oper == GEN_HOLD:
            zone.hold_tc = amount
        elif oper == GEN_DECAY:
            zone.decay_tc = amount
        elif oper == GEN_SUSTAIN:
            zone.sustain_cb = amount
        elif oper == GEN_RELEASE:
            zone.release_tc = amount

    def inst_zones(inst_idx: int) -> list:
        """Local zones of one instrument, inheriting its global zone."""
        lo = insts[inst_idx][1]
        hi = insts[inst_idx + 1][1] if inst_idx + 1 < len(insts) else len(ibag)
        zones, global_gens = [], []
        for b in range(lo, hi):
            g_lo = ibag[b][0]
            g_hi = ibag[b + 1][0] if b + 1 < len(ibag) else len(igen)
            gens = igen[g_lo:g_hi]
            sample_id = next(
                (a for o, a in gens if o == GEN_SAMPLE_ID), None)
            if sample_id is None:
                if not zones:  # first sample-less zone = global zone
                    global_gens = gens
                continue
            if sample_id >= len(shdr):
                continue
            zone = Sf2Zone(sample=shdr[sample_id])
            for oper, amount in global_gens:
                _apply_gen(zone, oper, amount)
            for oper, amount in gens:
                if oper != GEN_SAMPLE_ID:
                    _apply_gen(zone, oper, amount)
            zones.append(zone)
        return zones

    presets = []
    raw = hydra["phdr"]
    n_phdr = len(raw) // 38
    for i in range(n_phdr - 1):  # terminal EOP record
        name, program, bank, bag_ndx = struct.unpack_from("<20sHHH", raw, i * 38)[:4]
        next_bag = struct.unpack_from("<20sHHH", raw, (i + 1) * 38)[3]
        zones = []
        for b in range(bag_ndx, next_bag):
            g_lo = pbag[b][0]
            g_hi = pbag[b + 1][0] if b + 1 < len(pbag) else len(pgen)
            gens = pgen[g_lo:g_hi]
            inst_idx = next((a for o, a in gens if o == GEN_INSTRUMENT), None)
            if inst_idx is None or inst_idx >= len(insts):
                continue
            # preset-level key/vel ranges intersect the instrument zones'
            p_key = next(((a & 0xFF, (a >> 8) & 0xFF)
                          for o, a in gens if o == GEN_KEY_RANGE), (0, 127))
            p_vel = next(((a & 0xFF, (a >> 8) & 0xFF)
                          for o, a in gens if o == GEN_VEL_RANGE), (0, 127))
            for z in inst_zones(inst_idx):
                z = dataclasses.replace(z)
                z.key_lo = max(z.key_lo, p_key[0])
                z.key_hi = min(z.key_hi, p_key[1])
                z.vel_lo = max(z.vel_lo, p_vel[0])
                z.vel_hi = min(z.vel_hi, p_vel[1])
                if z.key_lo <= z.key_hi and z.vel_lo <= z.vel_hi:
                    zones.append(z)
        presets.append(Sf2Preset(
            name.split(b"\0")[0].decode("latin1"), bank, program, zones))

    return Sf2File(presets=presets, sample_data=sample_data)


# --------------------------------------------------------------- bank build


def bank_from_sf2(
    path: str,
    sample_rate: int = 16_000,
    seconds: float = 3.0,
    bank: int = 0,
    program: int = 0,
) -> tuple:
    """(samples [K, L], pitches [K], key_ranges [K, 2], vel_ranges [K, 2],
    release_tau [K]) for one preset, render-ready for the sample-bank voice.

    Each zone row: 16-bit PCM resampled to ``sample_rate``, loop-extended to
    ``seconds``, with the SF2 volume envelope's attack/hold/decay-to-sustain
    and initialAttenuation baked in. Release stays a playback-time param
    (``release_tau`` seconds time-constant) applied at note-off by
    ``synth/render.py``.
    """
    sf = parse_sf2(path)
    preset = next(
        (p for p in sf.presets if p.bank == bank and p.program == program),
        None)
    if preset is None:
        if not sf.presets:
            raise ValueError(f"{path}: no presets")
        preset = sf.presets[0]
    if not preset.zones:
        raise ValueError(f"{path}: preset '{preset.name}' has no zones")

    L = int(seconds * sample_rate)
    rows, pitches, keyr, velr, rel = [], [], [], [], []
    for z in preset.zones:
        s = z.sample
        start = s.start + z.start_ofs
        # clamp to the data that actually exists: a malformed end offset past
        # the smpl chunk would otherwise pass validation while numpy slicing
        # silently truncated the loop body (zero-padded garbage when tiled)
        end = min(s.end + z.end_ofs, len(sf.sample_data))
        s_loop = s.start_loop + z.startloop_ofs
        e_loop = s.end_loop + z.endloop_ofs
        data = sf.sample_data[start:end]
        if len(data) < 8 or start < 0:
            continue
        ratio = s.sample_rate / sample_rate
        # loop points must lie inside the sample; malformed files otherwise
        # produce negative relative indices (wrap-around garbage audio)
        loop_ok = z.loop and start <= s_loop < e_loop <= end
        if loop_ok:
            # materialize [start, end_loop) then tile the loop body
            head = data[: e_loop - start]
            body = data[s_loop - start: e_loop - start]
            need = int(np.ceil(L * ratio)) + 2
            if len(head) < need:
                reps = int(np.ceil((need - len(head)) / max(len(body), 1)))
                data = np.concatenate([head] + [body] * reps)
            else:
                data = head
        # linear-interp resample to the render rate
        pos = np.arange(L, dtype=np.float64) * ratio
        i0 = np.minimum(pos.astype(np.int64), max(len(data) - 2, 0))
        frac = (pos - i0).astype(np.float32)
        valid = pos < len(data) - 1
        row = (data[i0] * (1.0 - frac) + data[np.minimum(i0 + 1, len(data) - 1)]
               * frac) * valid

        # volume envelope: attack (linear ramp), hold, decay to sustain
        t = np.arange(L, dtype=np.float32) / sample_rate
        atk = _timecents_to_seconds(z.attack_tc)
        hold = _timecents_to_seconds(z.hold_tc)
        dec = _timecents_to_seconds(z.decay_tc)
        sus = _centibels_to_gain(min(max(z.sustain_cb, 0), 1440))
        env = np.ones(L, np.float32)
        if atk > 0:
            env = np.minimum(t / atk, 1.0)
        td = t - atk - hold
        if dec > 0:
            frac_dec = np.clip(td / dec, 0.0, 1.0)
            env = env * (1.0 + (sus - 1.0) * frac_dec)
        else:
            env = env * np.where(td > 0, sus, 1.0)
        row = row * env * _centibels_to_gain(z.atten_cb)

        rows.append(row.astype(np.float32))
        pitches.append(z.root_pitch)
        keyr.append((z.key_lo, z.key_hi))
        velr.append((z.vel_lo, z.vel_hi))
        rel.append(max(_timecents_to_seconds(z.release_tc), 0.01))

    if not rows:
        raise ValueError(f"{path}: no usable zones in preset '{preset.name}'")
    return (np.stack(rows), np.asarray(pitches, np.float32),
            np.asarray(keyr, np.float32), np.asarray(velr, np.float32),
            np.asarray(rel, np.float32))


# ------------------------------------------------------------------ writer


def write_sf2(
    path: str,
    zones: list,
    preset_name: str = "Preset",
    inst_name: str = "Inst",
    sample_rate: int = 16_000,
) -> None:
    """Write a minimal structurally-valid single-preset .sf2.

    ``zones``: list of dicts with keys ``wave`` (float32 [-1,1)), ``root``
    (int), and optional ``key_range``/``vel_range`` ((lo, hi)), ``loop``
    ((start, end) frames within the wave), ``attack_tc``/``hold_tc``/
    ``decay_tc``/``sustain_cb``/``release_tc``, ``fine_tune`` (cents),
    ``atten_cb``. Fixture/testing utility — enough of the spec for
    :func:`parse_sf2` and real SF2 players to read it back.
    """

    def pad_name(s: str) -> bytes:
        return s.encode("latin1")[:19].ljust(20, b"\0")

    smpl_parts, shdr_records = [], []
    pos = 0
    for i, z in enumerate(zones):
        w = np.clip(np.asarray(z["wave"], np.float32), -1.0, 1.0)
        pcm = np.round(w * 32767.0).astype("<i2")
        start = pos
        end = pos + len(pcm)
        loop = z.get("loop")
        sl, el = ((start + loop[0], start + loop[1]) if loop
                  else (start, end))
        shdr_records.append(struct.pack(
            "<20sIIIIIBbHH", pad_name(f"smp{i}"), start, end, sl, el,
            sample_rate, int(z["root"]), 0, 0, 1))
        smpl_parts.append(pcm.tobytes())
        smpl_parts.append(b"\0" * 92)  # 46 guard frames between samples
        pos = end + 46
    shdr_records.append(struct.pack(
        "<20sIIIIIBbHH", pad_name("EOS"), 0, 0, 0, 0, 0, 0, 0, 0, 0))

    igen_records, ibag_records = [], []
    for i, z in enumerate(zones):
        ibag_records.append(struct.pack("<HH", len(igen_records), 0))
        kr = z.get("key_range")
        if kr:
            igen_records.append(struct.pack(
                "<Hh", GEN_KEY_RANGE, (kr[0] & 0xFF) | (kr[1] << 8)))
        vr = z.get("vel_range")
        if vr:
            igen_records.append(struct.pack(
                "<Hh", GEN_VEL_RANGE, (vr[0] & 0xFF) | (vr[1] << 8)))
        for key, gen in (("attack_tc", GEN_ATTACK), ("hold_tc", GEN_HOLD),
                         ("decay_tc", GEN_DECAY), ("sustain_cb", GEN_SUSTAIN),
                         ("release_tc", GEN_RELEASE),
                         ("fine_tune", GEN_FINE_TUNE),
                         ("atten_cb", GEN_INITIAL_ATTEN),
                         ("start_ofs", GEN_START_ADDR_OFS),
                         ("end_ofs", GEN_END_ADDR_OFS),
                         ("startloop_ofs", GEN_STARTLOOP_OFS),
                         ("endloop_ofs", GEN_ENDLOOP_OFS)):
            if key in z:
                igen_records.append(struct.pack("<Hh", gen, int(z[key])))
        if z.get("loop"):
            igen_records.append(struct.pack("<Hh", GEN_SAMPLE_MODES, 1))
        igen_records.append(struct.pack("<Hh", GEN_SAMPLE_ID, i))
    ibag_records.append(struct.pack("<HH", len(igen_records), 0))
    igen_records.append(struct.pack("<Hh", 0, 0))  # terminal

    inst_records = [
        struct.pack("<20sH", pad_name(inst_name), 0),
        struct.pack("<20sH", pad_name("EOI"), len(ibag_records) - 1),
    ]

    pgen_records = [struct.pack("<Hh", GEN_INSTRUMENT, 0),
                    struct.pack("<Hh", 0, 0)]
    pbag_records = [struct.pack("<HH", 0, 0), struct.pack("<HH", 1, 0)]
    phdr_records = [
        struct.pack("<20sHHHIII", pad_name(preset_name), 0, 0, 0, 0, 0, 0),
        struct.pack("<20sHHHIII", pad_name("EOP"), 0, 0, 1, 0, 0, 0),
    ]

    def chunk(cid: bytes, payload: bytes) -> bytes:
        pad = b"\0" if len(payload) & 1 else b""
        return cid + struct.pack("<I", len(payload)) + payload + pad

    def list_chunk(kind: bytes, subs: bytes) -> bytes:
        return chunk(b"LIST", kind + subs)

    info = (chunk(b"ifil", struct.pack("<HH", 2, 1))
            + chunk(b"isng", b"EMU8000\0")
            + chunk(b"INAM", (preset_name + "\0").encode("latin1")))
    sdta = chunk(b"smpl", b"".join(smpl_parts))
    pdta = (chunk(b"phdr", b"".join(phdr_records))
            + chunk(b"pbag", b"".join(pbag_records))
            + chunk(b"pmod", struct.pack("<HHhHH", 0, 0, 0, 0, 0))
            + chunk(b"pgen", b"".join(pgen_records))
            + chunk(b"inst", b"".join(inst_records))
            + chunk(b"ibag", b"".join(ibag_records))
            + chunk(b"imod", struct.pack("<HHhHH", 0, 0, 0, 0, 0))
            + chunk(b"igen", b"".join(igen_records))
            + chunk(b"shdr", b"".join(shdr_records)))
    body = (b"sfbk" + list_chunk(b"INFO", info) + list_chunk(b"sdta", sdta)
            + list_chunk(b"pdta", pdta))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
