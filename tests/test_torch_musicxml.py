"""The port's MusicXML -> ABC converter (``abcnotation/from_musicxml.py``) and
``cli/batch_convert_xml.py`` against the JAX package's, on the 17 fixtures
of tests/test_musicxml.py (built here the same way): the same ABC text from
both, the same warnings, and the same batch trees.
"""

import contextlib
import io
import os
import random
import subprocess
import sys
import warnings
import zipfile

import pytest
import torch

from ai_music_generation_tpu.abcnotation.from_musicxml import (
    musicxml_to_abc as jax_musicxml_to_abc,
)
from ai_music_generation_tpu.cli import batch_convert_xml as jax_batch
from ai_music_generation_tpu_torch.abcnotation.from_musicxml import (
    musicxml_to_abc,
)
from ai_music_generation_tpu_torch.abcnotation.parser import AbcParser
from ai_music_generation_tpu_torch.cli import batch_convert_xml

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_musicxml(notes, fifths=0, beats=4, beat_type=4, divisions=2,
                  title="Test Tune"):
    """tests/test_musicxml.py's one-part builder: measures of (step,
    alter, octave, duration[, "chord"]) or ("rest", duration)."""
    out = ['<?xml version="1.0"?>', "<score-partwise>",
           f"<work><work-title>{title}</work-title></work>",
           '<part-list><score-part id="P1"/></part-list>', '<part id="P1">']
    for i, measure in enumerate(notes):
        out.append(f'<measure number="{i+1}">')
        if i == 0:
            out.append(
                f"<attributes><divisions>{divisions}</divisions>"
                f"<key><fifths>{fifths}</fifths></key>"
                f"<time><beats>{beats}</beats><beat-type>{beat_type}"
                "</beat-type></time></attributes>")
        for item in measure:
            if item[0] == "rest":
                out.append(f"<note><rest/><duration>{item[1]}</duration>"
                           "</note>")
            else:
                step, alter, octave, dur, *flags = item
                chord = "<chord/>" if "chord" in flags else ""
                alter_xml = f"<alter>{alter}</alter>" if alter else ""
                out.append(
                    f"<note>{chord}<pitch><step>{step}</step>{alter_xml}"
                    f"<octave>{octave}</octave></pitch>"
                    f"<duration>{dur}</duration></note>")
        out.append("</measure>")
    out.append("</part></score-partwise>")
    return "\n".join(out)


def _score(body, fifths=0, beats=4, beat_type=4, divisions=2):
    return f"""<?xml version="1.0"?>
<score-partwise version="3.1">
  <part-list><score-part id="P1"><part-name>A</part-name></score-part></part-list>
  <part id="P1">
    <measure number="1">
      <attributes>
        <divisions>{divisions}</divisions>
        <key><fifths>{fifths}</fifths></key>
        <time><beats>{beats}</beats><beat-type>{beat_type}</beat-type></time>
      </attributes>
{body}
    </measure>
  </part>
</score-partwise>"""


def _note(step, octave, dur, voice=None, extra=""):
    v = f"<voice>{voice}</voice>" if voice else ""
    return (f"<note><pitch><step>{step}</step><octave>{octave}</octave>"
            f"</pitch><duration>{dur}</duration>{v}{extra}</note>")


def _one_part(measures, attrs="<key><fifths>0</fifths></key><time><beats>4"
              "</beats><beat-type>4</beat-type></time>", divisions=1):
    """A one-part score of raw measure bodies, the first with attributes."""
    body = "".join(
        f'<measure number="{i + 1}">'
        + (f"<attributes><divisions>{divisions}</divisions>{attrs}"
           "</attributes>" if i == 0 else "")
        + m + "</measure>" for i, m in enumerate(measures))
    return ('<?xml version="1.0"?><score-partwise><part-list><score-part '
            f'id="P1"/></part-list><part id="P1">{body}</part>'
            "</score-partwise>")


def _pitch(step, octave, dur, voice=None, alter=""):
    v = f"<voice>{voice}</voice>" if voice else ""
    return (f"<note>{v}<pitch><step>{step}</step>{alter}<octave>{octave}"
            f"</octave></pitch><duration>{dur}</duration></note>")


def _fuzz_case(case):
    """tests/test_musicxml.py::test_musicxml_round_trip_fuzz's case."""
    rng = random.Random(77_000 + case)
    fifths = rng.randint(-5, 5)
    divisions = rng.choice([1, 2, 4])
    beats, beat_type = rng.choice([(4, 4), (3, 4), (6, 8)])
    total_units = int(4 * beats * divisions // beat_type)
    measures = []
    for _ in range(rng.randint(1, 3)):
        m, remaining = [], total_units
        while remaining:
            dur = rng.randint(1, min(remaining, 4 * divisions))
            if rng.random() < 0.2:
                m.append(("rest", dur))
            else:
                k = 1 if rng.random() < 0.85 else rng.randint(2, 3)
                seen = set()
                base = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9,
                        "B": 11}
                for ci in range(k):
                    step = rng.choice("CDEFGAB")
                    alter = rng.choice([-1, 0, 0, 0, 1])
                    octave = rng.randint(3, 5)
                    midi = 12 * (octave + 1) + base[step] + alter
                    if midi in seen:
                        continue
                    seen.add(midi)
                    m.append((step, alter, octave, dur)
                             + (("chord",) if ci else ()))
            remaining -= dur
        measures.append(m)
    return make_musicxml(measures, fifths=fifths, beats=beats,
                         beat_type=beat_type, divisions=divisions)


def _rests_chords():
    xml = make_musicxml([[("rest", 4), ("C", 0, 4, 2, "x"),
                          ("E", 0, 4, 2, "chord"), ("G", 0, 4, 2, "chord")]])
    return xml.replace('<note><chord/><pitch><step>C</step>',
                       '<note><pitch><step>C</step>', 1)


_ORN = "<notations><ornaments><trill-mark/></ornaments></notations>"
_TM = ("<time-modification><actual-notes>3</actual-notes>"
       "<normal-notes>2</normal-notes></time-modification>")

# name -> (file name, the file's text; an .mxl holds it as score.xml)
FIXTURES = {
    "basic": ("t.xml", make_musicxml([
        [("C", 0, 4, 2), ("D", 0, 4, 2), ("E", 0, 4, 2), ("F", 0, 4, 2)],
        [("G", 0, 4, 8)]])),
    "key_signature_and_accidentals": ("t.xml", make_musicxml(
        [[("F", 1, 4, 2), ("F", 0, 4, 2), ("C", 1, 5, 4)]], fifths=2)),
    "rests_chords_and_mxl": ("t.mxl", _rests_chords()),
    "batch_converter": ("t0.xml", make_musicxml(
        [[("C", 0, 4, 2), ("D", 0, 4, 2)]], title="T0")),
    "multivoice_backup": ("mv.xml", _score(
        _note("C", 4, 4, voice=1) + _note("D", 4, 4, voice=1)
        + "<backup><duration>8</duration></backup>"
        + _note("E", 3, 4, voice=2) + _note("F", 3, 4, voice=2))),
    "multipart": ("mp.xml", f"""<?xml version="1.0"?>
<score-partwise version="3.1">
  <part-list><score-part id="P1"/><score-part id="P2"/></part-list>
  <part id="P1"><measure number="1">
    <attributes><divisions>1</divisions>
      <key><fifths>0</fifths></key>
      <time><beats>4</beats><beat-type>4</beat-type></time></attributes>
    {_note("C", 5, 4)}
  </measure></part>
  <part id="P2"><measure number="1">
    <attributes><divisions>1</divisions></attributes>
    {_note("C", 3, 4)}
  </measure></part>
</score-partwise>"""),
    "tuplet": ("tup.xml", _score(
        "".join(_note(s, 4, 2, extra=_TM) for s in "CDE")
        + _note("F", 4, 6), divisions=6)),
    "grace": ("gr.xml", _score(
        "<note><grace/><pitch><step>A</step><octave>4</octave></pitch>"
        "</note>" + _note("G", 4, 8))),
    "ornaments": ("orn.xml", _score(_note("C", 4, 4, extra=_ORN)
                                    + _note("D", 4, 4, extra=_ORN))),
    "forward": ("fw.xml", _score(
        _note("C", 4, 2, voice=1)
        + "<forward><duration>2</duration><voice>1</voice></forward>"
        + _note("E", 4, 2, voice=1) + _note("F", 4, 2, voice=1))),
    "mxl_container_multivoice": ("c.mxl", _score(
        _note("C", 4, 4, voice=1) + "<backup><duration>4</duration></backup>"
        + _note("E", 3, 4, voice=2) + _note("G", 4, 4, voice=1)
        + "<backup><duration>4</duration></backup>"
        + _note("B", 3, 4, voice=2))),
    "volta": ("t.xml", _one_part([
        _pitch("C", 4, 2),
        '<barline location="left"><ending number="1" type="start"/>'
        "</barline>" + _pitch("D", 4, 2)
        + '<barline location="right"><ending number="1" type="stop"/>'
        '<repeat direction="backward"/></barline>',
        '<barline location="left"><ending number="2" type="start"/>'
        "</barline>" + _pitch("E", 4, 2)],
        attrs="<key><fifths>0</fifths></key><time><beats>2</beats>"
        "<beat-type>4</beat-type></time>")),
    "harmony": ("t.xml", _one_part([
        "<harmony><root><root-step>G</root-step></root><kind>dominant"
        "</kind></harmony>" + _pitch("G", 4, 2)
        + "<harmony><root><root-step>D</root-step></root><kind>minor</kind>"
        "<bass><bass-step>F</bass-step><bass-alter>1</bass-alter></bass>"
        "</harmony>" + _pitch("D", 4, 2)])),
    "score_directive": ("t.xml", """<?xml version="1.0"?>
<score-partwise>
<part-list><score-part id="P1"/><score-part id="P2"/></part-list>
<part id="P1"><measure number="1">
 <attributes><divisions>1</divisions><key><fifths>0</fifths></key>
 <time><beats>4</beats><beat-type>4</beat-type></time></attributes>
 <note><voice>1</voice><pitch><step>C</step><octave>5</octave></pitch><duration>4</duration></note>
 <backup><duration>4</duration></backup>
 <note><voice>2</voice><pitch><step>E</step><octave>4</octave></pitch><duration>4</duration></note>
</measure></part>
<part id="P2"><measure number="1">
 <note><pitch><step>C</step><octave>3</octave></pitch><duration>4</duration></note>
</measure></part>
</score-partwise>"""),
    "mid_tune_key_and_meter_change": ("t.xml", _one_part([
        _pitch("F", 4, 4),
        "<attributes><key><fifths>1</fifths></key><time><beats>3</beats>"
        "<beat-type>4</beat-type></time></attributes>" + _pitch("F", 4, 3)])),
    "mid_tune_voice_alignment": ("v.xml", _one_part([
        _pitch("C", 4, 8, voice=1), _pitch("D", 4, 8, voice=1),
        _pitch("E", 4, 8, voice=1) + "<backup><duration>8</duration>"
        "</backup>" + _pitch("G", 3, 8, voice=2)], divisions=2)),
}
FIXTURES.update({f"fuzz_{case:03d}": (f"fuzz{case}.xml", _fuzz_case(case))
                 for case in range(150)})


def _write(path, text):
    if path.suffix == ".mxl":
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("score.xml", text)
    else:
        path.write_text(text)
    return path


def _convert(fn, path, reference):
    """(ABC text, the messages of every warning it raised)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        abc = fn(path, reference=reference)
    return abc, [str(w.message) for w in caught]


@pytest.mark.parametrize("fixture", ["basic", "key_signature_and_accidentals",
                                     "rests_chords_and_mxl", "batch_converter",
                                     "multivoice_backup", "multipart",
                                     "tuplet", "grace", "ornaments",
                                     "forward", "mxl_container_multivoice",
                                     "volta", "harmony", "score_directive",
                                     "mid_tune_key_and_meter_change",
                                     "round_trip_fuzz",
                                     "mid_tune_voice_alignment"])
def test_musicxml_to_abc_equals_jax(tmp_path, fixture):
    """The same ABC text and warnings from both converters (as a path and
    as a str, at two reference numbers); the fuzz fixture's 150 seeded
    files each. The ABC parses with the port's parser."""
    names = ([n for n in FIXTURES if n.startswith("fuzz_")]
             if fixture == "round_trip_fuzz" else [fixture])
    for name in names:
        file_name, text = FIXTURES[name]
        path = _write(tmp_path / file_name, text)
        for arg, ref in ((path, 1), (str(path), 7)):
            got = _convert(musicxml_to_abc, arg, ref)
            assert got == _convert(jax_musicxml_to_abc, arg, ref), name
        assert AbcParser().parse(got[0]).notes, name


def test_ornaments_warn_once_per_file_as_jax(tmp_path):
    """One warning per file with ornaments, none for a file without; the
    same count from both converters."""
    orn = _write(tmp_path / "orn.xml", FIXTURES["ornaments"][1])
    plain = _write(tmp_path / "t.xml", FIXTURES["basic"][1])
    for fn in (musicxml_to_abc, jax_musicxml_to_abc):
        counts = [len(_convert(fn, p, 1)[1]) for p in (orn, plain, orn)]
        assert counts == [1, 0, 1]
    with pytest.warns(UserWarning, match="ornaments"):
        musicxml_to_abc(orn)


def test_batch_convert_xml_trees_equal_jax(tmp_path):
    """convert_directory and main over 20 fixture files (.mxl ones
    included), a malformed file and a file of another suffix: the same
    .abc files byte for byte, counts and reference numbers (X:) as the
    original's; then the port's CLI with a pool of two in a fresh
    interpreter (this process holds jax's and torch's threads, under which
    a fork is unsafe), which writes the same tree."""
    src = tmp_path / "xml"
    src.mkdir()
    for i, name in enumerate(list(FIXTURES)[:20]):
        file_name, text = FIXTURES[name]
        stem, suffix = os.path.splitext(file_name)
        _write(src / f"{i:02d}_{stem}{suffix}", text)
    (src / "bad.xml").write_text("<not-musicxml/>")
    (src / "notes.txt").write_text("not a score")
    def abc_tree(out):
        return {p.relative_to(out).as_posix(): p.read_bytes()
                for p in out.rglob("*.abc")}

    trees = {}
    for side, mod in (("jax", jax_batch), ("port", batch_convert_xml)):
        out = tmp_path / side
        with warnings.catch_warnings(), \
                contextlib.redirect_stdout(io.StringIO()):
            warnings.simplefilter("ignore")
            counts = mod.convert_directory(str(src), str(out), processes=1)
            main_counts = mod.main([str(src), str(out / "cli"),
                                    "--processes=1"])
        trees[side] = (counts, main_counts, abc_tree(out))
    assert trees["port"] == trees["jax"]
    assert trees["port"][0] == (20, 1)
    assert len(trees["port"][2]) == 40
    pooled = tmp_path / "pooled"
    proc = subprocess.run(
        [sys.executable, "-m", "ai_music_generation_tpu_torch.cli."
         "batch_convert_xml", str(src), str(pooled), "--processes=2"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert "converted 20 files, 1 failures" in proc.stdout
    assert abc_tree(pooled) == abc_tree(tmp_path / "jax" / "cli")
