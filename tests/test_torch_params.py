"""The port's request and engine parameters against the reference's: the
same dataclass fields with the same defaults, apart from the one
difference the port's `EngineConfig` docstring names (``stall_ticks``
defaults to None until the stall watchdog is ported); and, on the same
inputs, the same ``is_greedy`` and the same refusal of a priority that is
not an int."""
import dataclasses

import pytest

from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.serving import EngineConfig, SamplingParams

# field -> (reference default, port default): the documented differences
DIFFERENCES = {"stall_ticks": (500, None)}


def _defaults(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory())
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("ref,port", [(RefEngineConfig, EngineConfig),
                                      (RefSamplingParams, SamplingParams)],
                         ids=["EngineConfig", "SamplingParams"])
def test_fields_and_defaults_match_the_reference(ref, port):
    want, got = _defaults(ref), _defaults(port)
    assert list(got) == list(want)
    for name, value in want.items():
        if name in DIFFERENCES:
            assert (value, got[name]) == DIFFERENCES[name], name
        else:
            assert got[name] == value, name


def test_preempt_loop_limit_is_accepted():
    assert EngineConfig(preempt_loop_limit=3).preempt_loop_limit == 3
    assert EngineConfig().preempt_loop_limit == 8


@pytest.mark.parametrize("temperature", [0.0, -0.0])
def test_is_greedy_matches_the_reference(temperature):
    kw = dict(temperature=temperature, max_new_tokens=4)
    assert SamplingParams(**kw).is_greedy == \
        RefSamplingParams(**kw).is_greedy is True
    assert SamplingParams.greedy().is_greedy


@pytest.mark.parametrize("priority", ["1", 1.5, None, 0, False])
def test_priority_int_check_matches_the_reference(priority):
    kw = dict(temperature=0.0, priority=priority)
    outcomes = []
    for cls in (RefSamplingParams, SamplingParams):
        try:
            cls(**kw)
            outcomes.append("ok")
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
