"""MusicXML -> ABC conversion.

Replaces the reference's vendored ``xml2abc.py`` (2,300 LoC, driven by
``batch_converter.py`` in tunesformer/data_curation.zip) with a clean-room
converter for the score-partwise subset the TunesFormer curation pipeline
needs: multiple parts and multiple voices per part (emitted as ABC ``V:``
lines; ``<backup>`` interleaving handled by voice partitioning), divisions,
key (fifths) / time attributes, pitched notes and rests with exact
durations, chords, ties, tuplets (``<time-modification>`` re-emitted as
``(p:q:r`` groups), grace notes (re-emitted as ABC ``{...}`` groups),
``<forward>`` gaps (as rests), repeat barlines, volta endings
(``<ending>`` -> ``[1``/``[2``), ``<harmony>`` chord symbols (-> ``"G7"``,
feeding the gchord engine), mid-tune key/meter changes (-> inline ``[K:]``
/``[M:]`` fields), and a ``%%score`` staff-layout directive for multi-part
scores. Ornaments/dynamics are skipped with a single warning per file.
``.mxl`` (zipped MusicXML) is handled transparently.

Output is ABC text directly consumable by the in-repo ABC parser and the
control-code curation (data/curation.py).

The port's copy of ``ai_music_generation_tpu/abcnotation/from_musicxml.py``
(stdlib only; the once-per-file ornament warning is local to each call):
the same file gives the same ABC text (tests/test_torch_musicxml.py).
"""

from __future__ import annotations

import io
import warnings
import zipfile
from dataclasses import dataclass, field
from fractions import Fraction
from pathlib import Path
from typing import Optional
from xml.etree import ElementTree as ET

_SHARP_KEYS = ["C", "G", "D", "A", "E", "B", "F#", "C#"]
_FLAT_KEYS = ["C", "F", "Bb", "Eb", "Ab", "Db", "Gb", "Cb"]

# which letters carry an accidental for a given fifths count
_SHARP_ORDER = "FCGDAEB"


def _key_name(fifths: int, mode: str = "major") -> str:
    if mode.lower().startswith("min"):
        minors = ["A", "E", "B", "F#", "C#", "G#", "D#", "A#"]
        minors_flat = ["A", "D", "G", "C", "F", "Bb", "Eb", "Ab"]
        return (minors[fifths] if fifths >= 0 else minors_flat[-fifths]) + "m"
    return _SHARP_KEYS[fifths] if fifths >= 0 else _FLAT_KEYS[-fifths]


def _signature_alters(fifths: int) -> dict[str, int]:
    out: dict[str, int] = {}
    if fifths > 0:
        for letter in _SHARP_ORDER[:fifths]:
            out[letter] = 1
    elif fifths < 0:
        for letter in reversed(_SHARP_ORDER[len(_SHARP_ORDER) + fifths:]):
            out[letter] = -1
    return out


def _pitch_to_abc(step: str, alter: int, octave: int, key_alters: dict[str, int],
                  measure_state: dict) -> str:
    """MusicXML pitch -> ABC note, emitting an explicit accidental whenever
    the alteration differs from the current EFFECTIVE state (key signature
    overridden by earlier accidentals on the same letter+octave this
    measure) — matching ABC's measure-propagation semantics."""
    effective = measure_state.get((step, octave), key_alters.get(step, 0))
    prefix = ""
    if alter != effective:
        prefix = {2: "^^", 1: "^", 0: "=", -1: "_", -2: "__"}.get(alter, "")
        measure_state[(step, octave)] = alter
    if octave >= 5:
        body = step.lower() + "'" * (octave - 5)
    else:
        body = step + "," * (4 - octave)
    return prefix + body


def _dur_to_abc(units: Fraction) -> str:
    """duration in L-units -> ABC length suffix."""
    if units == 1:
        return ""
    if units.denominator == 1:
        return str(units.numerator)
    if units.numerator == 1 and units.denominator == 2:
        return "/"
    return f"{units.numerator}/{units.denominator}"


def load_musicxml(path) -> ET.Element:
    path = Path(path)
    data = path.read_bytes()
    if data[:2] == b"PK":  # .mxl container
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            names = [n for n in z.namelist()
                     if n.endswith(".xml") and not n.startswith("META-INF")]
            if not names:
                raise ValueError(f"{path}: no MusicXML inside .mxl")
            data = z.read(names[0])
    return ET.fromstring(data)


@dataclass
class _Item:
    """One renderable token: a note/chord/rest with its length and context."""
    core: str  # 'C' / '[CEG]' / 'z' (no length suffix)
    units: Fraction
    timemod: Optional[tuple[int, int]] = None  # (actual, normal)
    tie: bool = False
    grace: str = ""  # '{ag}' prefix
    sym: str = ""  # '"G7"' chord-symbol prefix (from <harmony>)


# MusicXML <kind> -> ABC chord-symbol suffix, targeting the suffixes the
# in-repo gchord engine understands (parser.py _CHORD_TYPES).
_HARMONY_KINDS = {
    "major": "", "minor": "m", "augmented": "aug", "diminished": "dim",
    "dominant": "7", "major-seventh": "maj7", "minor-seventh": "m7",
    "diminished-seventh": "dim7", "half-diminished": "m7b5",
    "augmented-seventh": "aug7", "major-sixth": "6", "minor-sixth": "m6",
    "dominant-ninth": "9", "major-ninth": "maj9", "minor-ninth": "m9",
    "dominant-11th": "11", "suspended-fourth": "sus4",
    "suspended-second": "sus2", "power": "5", "none": None,
}
_ALTER_TO_SYM = {1: "#", -1: "b", 0: ""}


def _harmony_to_symbol(h: ET.Element) -> Optional[str]:
    """<harmony> -> ABC chord symbol text ('G7', 'Dm/F#', ...) or None."""
    step = h.find("root/root-step")
    if step is None or not step.text:
        return None
    alter = h.find("root/root-alter")
    acc = _ALTER_TO_SYM.get(
        int(float(alter.text)) if alter is not None and alter.text else 0, "")
    kind_el = h.find("kind")
    kind = (kind_el.text or "").strip() if kind_el is not None else "major"
    suffix = _HARMONY_KINDS.get(kind, "")
    if suffix is None:  # kind "none" = explicit no-chord
        return None
    sym = step.text.strip() + acc + suffix
    b_step = h.find("bass/bass-step")
    if b_step is not None and b_step.text:
        b_alter = h.find("bass/bass-alter")
        b_acc = _ALTER_TO_SYM.get(
            int(float(b_alter.text))
            if b_alter is not None and b_alter.text else 0, "")
        sym += "/" + b_step.text.strip() + b_acc
    return sym


@dataclass
class _VoiceCtx:
    measure_state: dict = field(default_factory=dict)
    graces: list = field(default_factory=list)
    items: list = field(default_factory=list)  # current measure's _Items
    bars: list = field(default_factory=list)  # rendered bar strings


def _render_items(items: list[_Item]) -> str:
    """Items -> bar text, grouping consecutive equal time-modifications into
    ``(p:q:r`` tuplets (written lengths get the modification undone, so the
    ABC parser's tuplet factor reproduces the exact played durations)."""
    tokens: list[str] = []
    i = 0
    while i < len(items):
        it = items[i]
        if it.timemod is None:
            tokens.append(it.sym + it.grace + it.core + _dur_to_abc(it.units)
                          + ("-" if it.tie else ""))
            i += 1
            continue
        j = i
        while j < len(items) and items[j].timemod == it.timemod:
            j += 1
        a, b = it.timemod
        tokens.append(f"({a}:{b}:{j - i}")
        for k in range(i, j):
            x = items[k]
            written = x.units * a / b  # undo the modification
            tokens.append(x.sym + x.grace + x.core + _dur_to_abc(written)
                          + ("-" if x.tie else ""))
        i = j
    return " ".join(tokens)


def musicxml_to_abc(path, reference: int = 1, unit: Fraction = Fraction(1, 8)) -> str:
    """Convert a MusicXML file to ABC text. All parts and voices are kept;
    with more than one voice the output uses ``V:`` lines."""
    root = load_musicxml(path)
    if root.tag != "score-partwise":
        raise ValueError(f"unsupported MusicXML root {root.tag!r}")

    title = None
    work = root.find("work/work-title")
    if work is not None and work.text:
        title = work.text.strip()

    parts = root.findall("part")
    if not parts:
        raise ValueError("no <part> in MusicXML")

    quarter_per_unit = unit * 4  # quarters per ABC unit note
    fifths = 0
    mode = "major"
    beats, beat_type = 4, 4
    header_attrs_set = False
    skipped_ornaments = False

    voices: dict[tuple[int, str], _VoiceCtx] = {}
    voice_order: list[tuple[int, str]] = []

    def ctx(p_idx: int, vid: str, m_idx: int = 0) -> _VoiceCtx:
        key = (p_idx, vid)
        if key not in voices:
            voices[key] = _VoiceCtx()
            voice_order.append(key)
            # a voice first appearing in measure m_idx needs m_idx full-
            # measure rest bars to stay time-aligned with the tune start
            # ('' placeholders were dropped at output, so its notes played
            # from t=0 — review finding; count is the measure index, not
            # the previous max-1)
            voices[key].bars = ["Z |"] * m_idx
        return voices[key]

    for p_idx, part in enumerate(parts):
        divisions = 1
        key_alters: dict[str, int] = {}
        part_fifths: Optional[int] = None
        part_mode = "major"
        part_time: Optional[tuple[int, int]] = None
        pending_sym: Optional[str] = None

        for m_idx, measure in enumerate(part.findall("measure")):
            inline_prefix = ""  # mid-tune [K:]/[M:] changes for this measure
            attrs = measure.find("attributes")
            if attrs is not None:
                d = attrs.find("divisions")
                if d is not None:
                    divisions = int(d.text)
                k = attrs.find("key/fifths")
                m_el = attrs.find("key/mode")
                new_mode = (m_el.text if m_el is not None and m_el.text
                            else part_mode)
                if k is not None:
                    new_fifths = int(k.text)
                    key_alters = _signature_alters(new_fifths)
                    # header K: the tune's OPENING key (part 0, bar 1);
                    # later changes become inline [K:] fields
                    if not header_attrs_set or (p_idx == 0 and m_idx == 0):
                        fifths, mode = new_fifths, new_mode
                    if m_idx > 0 and (new_fifths, new_mode) != (
                            part_fifths, part_mode):
                        inline_prefix += f"[K:{_key_name(new_fifths, new_mode)}] "
                    elif m_idx == 0 and (new_fifths, new_mode) != (fifths, mode):
                        # a part OPENING in a different key than the header
                        # (e.g. transposing instrument) needs its own [K:],
                        # else its signature accidentals are lost on parse
                        inline_prefix += f"[K:{_key_name(new_fifths, new_mode)}] "
                    part_fifths, part_mode = new_fifths, new_mode
                t = attrs.find("time")
                if t is not None:
                    new_time = (int(t.find("beats").text),
                                int(t.find("beat-type").text))
                    if not header_attrs_set or (p_idx == 0 and m_idx == 0):
                        beats, beat_type = new_time
                    if m_idx > 0 and new_time != part_time:
                        inline_prefix += f"[M:{new_time[0]}/{new_time[1]}] "
                    elif m_idx == 0 and new_time != (beats, beat_type):
                        inline_prefix += f"[M:{new_time[0]}/{new_time[1]}] "
                    part_time = new_time
                header_attrs_set = True

            cur_vid = "1"
            measure_voices: list[str] = []
            for el in measure:
                if el.tag == "harmony":
                    # chord symbol: attaches to the NEXT note/rest
                    # (xml2abc behavior for <harmony> -> "sym")
                    pending_sym = _harmony_to_symbol(el)
                    continue
                if el.tag == "forward":
                    # explicit gap: render as a rest in its voice
                    v_el = el.find("voice")
                    vid = (v_el.text.strip() if v_el is not None and v_el.text
                           else cur_vid)
                    dur_el = el.find("duration")
                    if dur_el is not None:
                        units = Fraction(int(dur_el.text), divisions) / quarter_per_unit
                        v = ctx(p_idx, vid, m_idx)
                        v.items.append(_Item("z", units))
                        if vid not in measure_voices:
                            measure_voices.append(vid)
                    continue
                if el.tag != "note":
                    continue  # backup handled implicitly by voice partition
                note = el
                v_el = note.find("voice")
                cur_vid = (v_el.text.strip() if v_el is not None and v_el.text
                           else cur_vid)
                v = ctx(p_idx, cur_vid, m_idx)
                if cur_vid not in measure_voices:
                    measure_voices.append(cur_vid)
                if note.find("notations/ornaments") is not None:
                    skipped_ornaments = True

                pitch = note.find("pitch")
                if note.find("grace") is not None:
                    if pitch is not None:
                        v.graces.append(_pitch_to_abc(
                            pitch.find("step").text,
                            int(float(pitch.find("alter").text))
                            if pitch.find("alter") is not None else 0,
                            int(pitch.find("octave").text),
                            key_alters, v.measure_state,
                        ))
                    continue
                dur_el = note.find("duration")
                if dur_el is None:
                    continue
                units = Fraction(int(dur_el.text), divisions) / quarter_per_unit
                timemod = None
                tm = note.find("time-modification")
                if tm is not None:
                    timemod = (int(tm.find("actual-notes").text),
                               int(tm.find("normal-notes").text))
                if note.find("rest") is not None:
                    v.graces.clear()
                    v.items.append(_Item(
                        "z", units, timemod,
                        sym=f'"{pending_sym}"' if pending_sym else ""))
                    pending_sym = None
                    continue
                if pitch is None:
                    continue
                abc_note = _pitch_to_abc(
                    pitch.find("step").text,
                    int(float(pitch.find("alter").text))
                    if pitch.find("alter") is not None else 0,
                    int(pitch.find("octave").text),
                    key_alters, v.measure_state,
                )
                tie = any(t.get("type") == "start" for t in note.findall("tie"))
                if note.find("chord") is not None and v.items \
                        and v.items[-1].core != "z":
                    last = v.items[-1]
                    inner = last.core[1:-1] if last.core.startswith("[") else last.core
                    last.core = "[" + inner + abc_note + "]"
                    last.tie = last.tie or tie
                    continue
                grace = "{" + "".join(v.graces) + "}" if v.graces else ""
                v.graces.clear()
                v.items.append(_Item(
                    abc_note, units, timemod, tie, grace,
                    sym=f'"{pending_sym}"' if pending_sym else ""))
                pending_sym = None

            # barline for this measure (applies to every voice of this part)
            bar_prefix = ""
            barline = "|"
            for bl in measure.findall("barline"):
                rep = bl.find("repeat")
                style = bl.find("bar-style")
                ending = bl.find("ending")
                if ending is not None and ending.get("type") == "start":
                    # volta: '[1 ' / '[2 ' before the measure content
                    num = (ending.get("number") or "1").split(",")[0].strip()
                    if num.isdigit():
                        bar_prefix += f"[{num} "
                if rep is not None and rep.get("direction") == "backward":
                    barline = ":|"
                elif rep is not None and rep.get("direction") == "forward":
                    if m_idx > 0:
                        bar_prefix += "|: "
                elif style is not None and style.text == "light-heavy":
                    barline = "|]"

            for vid in measure_voices or ["1"]:
                v = ctx(p_idx, vid, m_idx)
                v.bars.append(bar_prefix + inline_prefix
                              + _render_items(v.items) + " " + barline)
                v.items = []
                v.measure_state = {}
                v.graces.clear()
            # voices absent from this measure keep alignment with a
            # full-measure rest bar (an '' placeholder was dropped at
            # output, collapsing the timeline)
            for (pp, vid), v in voices.items():
                if pp == p_idx and vid not in measure_voices \
                        and len(v.bars) == m_idx:
                    v.bars.append("Z |")

    if skipped_ornaments:
        warnings.warn(
            f"{path}: ornaments present in MusicXML were skipped "
            "(no ABC equivalent emitted)", stacklevel=2,
        )

    header = [f"X:{reference}"]
    if title:
        header.append(f"T:{title}")
    header.append(f"M:{beats}/{beat_type}")
    header.append(f"L:{unit.numerator}/{unit.denominator}")
    header.append(f"K:{_key_name(fifths, mode)}")
    body: list[str] = []
    if len(voice_order) <= 1:
        v = voices[voice_order[0]] if voice_order else _VoiceCtx()
        body.extend(b for b in v.bars if b)
    else:
        # %%score layout directive: voices of the same part brace-grouped
        # on one staff system (xml2abc emits the same directive; the in-repo
        # parser skips %% lines, parser.py:282)
        groups: list[str] = []
        for p_idx in sorted({p for p, _ in voice_order}):
            vs = [str(i + 1) for i, (pp, _) in enumerate(voice_order)
                  if pp == p_idx]
            groups.append("(" + " ".join(vs) + ")" if len(vs) > 1 else vs[0])
        header.insert(len(header) - 1, "%%score " + " ".join(groups))
        for n, key in enumerate(voice_order, start=1):
            body.append(f"V:{n}")
            body.extend(b for b in voices[key].bars if b)
    return "\n".join(header) + "\n" + "\n".join(body) + "\n"
