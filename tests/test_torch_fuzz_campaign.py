"""The fuzz campaign of the port (ai_music_generation_tpu_torch/experiments/
fuzz_campaign.py) against docs/experiments/fuzz_campaign.py and the
grammar it imports from tests/test_fuzz.py.

- the port's own copy of the grammar: ``random_tune`` byte-equal to
  tests/test_fuzz.py's for seeds 0-999, ``_note_set(_random_score(s))``
  equal for 200 seeds (the JAX codec's scores against the port's);
- ``main(["--abc", "300", "--codec", "30"])`` exits 0 with its JSON line
  and ``CAMPAIGN CLEAN``; a Python parser that drops a note makes it exit 1
  and print the case's ``DIVERGENCE`` line, a converter that drops a note
  its ``ROUND-TRIP FAIL`` line.
"""

import importlib.util
import json
import os

import pytest
import torch

from ai_music_generation_tpu_torch.experiments import fuzz_campaign

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def jax_fuzz():
    """tests/test_fuzz.py as a module (its grammar imports the JAX
    package's codec)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_test_fuzz", os.path.join(TESTS, "test_fuzz.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_random_tune_is_byte_equal(jax_fuzz):
    for seed in range(1000):
        assert fuzz_campaign.random_tune(seed) == jax_fuzz.random_tune(seed), \
            seed


def test_grammar_constants_are_the_tests(jax_fuzz):
    for name in ("LETTERS", "ACCIDENTALS", "OCTAVES", "LENGTHS", "KEYS",
                 "METERS", "UNITS", "DECOS", "CHORD_SYMS"):
        assert getattr(fuzz_campaign, name) == getattr(jax_fuzz, name), name


def test_note_sets_of_random_scores_are_equal(jax_fuzz):
    for seed in range(200):
        want = jax_fuzz._note_set(jax_fuzz._random_score(seed))
        assert fuzz_campaign._note_set(fuzz_campaign._random_score(seed)) \
            == want, seed


def test_note_set_drops_all_rest_parts_first(jax_fuzz):
    """filter_allowed_parts' rule: a part without a pitched note is dropped
    before the parts are numbered (seed 0 has three parts; the first is
    made all rests in both packages' scores)."""
    sets = []
    for module in (jax_fuzz, fuzz_campaign):
        score = module._random_score(0)
        for m in score.parts[0].measures:
            for n in m.notes:
                n.pitches = ()
        sets.append(module._note_set(score))
    assert sets[1] == sets[0]
    assert {part for part, *_ in sets[1]} == {0, 1}


def test_main_is_clean(capsys):
    assert fuzz_campaign.main(["--abc", "300", "--codec", "30"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "CAMPAIGN CLEAN"
    result = json.loads(out[-2])
    assert result["clean"] and result["study"] == "fuzz_campaign"
    assert result["abc"]["cases"] == 300 and result["abc"]["divergences"] == 0
    assert result["codec"]["cases"] == 90 and result["codec"]["failures"] == 0
    assert "abc differential: 300 cases, 0 divergences" in "\n".join(out)


def test_a_dropped_note_fails_the_campaign(monkeypatch, capsys):
    from ai_music_generation_tpu_torch.abcnotation.parser import AbcParser

    parse = AbcParser.parse

    def lossy(self, abc):
        tune = parse(self, abc)
        del tune.notes[-1:]
        return tune

    monkeypatch.setattr(AbcParser, "parse", lossy)
    assert fuzz_campaign.main(["--abc", "3", "--codec", "2"]) == 1
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "CAMPAIGN FAILED"
    assert f"DIVERGENCE case 0:\n{fuzz_campaign.random_tune(0)}\n" in out


def test_a_lossy_round_trip_fails_the_campaign(monkeypatch, capsys):
    from ai_music_generation_tpu_torch.codec.quantized_converter import (
        MidiQuantizedConverter,
    )

    back = MidiQuantizedConverter.text_to_score

    def lossy(self, text, *args, **kwargs):
        score = back(self, text, *args, **kwargs)
        notes = score.parts[0].measures[0].notes
        first = next(i for i, n in enumerate(notes) if n.pitches)
        del notes[first]  # the first pitched note
        return score

    monkeypatch.setattr(MidiQuantizedConverter, "text_to_score", lossy)
    assert fuzz_campaign.main(["--abc", "2", "--codec", "2"]) == 1
    out = capsys.readouterr().out
    assert "ROUND-TRIP FAIL [Queue parallel measures offsets=True] case 0" \
        in out
    assert out.strip().splitlines()[-1] == "CAMPAIGN FAILED"
