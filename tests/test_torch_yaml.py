"""The port's YAML text and parsing against the JAX package's.

The port reads and writes YAML through libyaml where PyYAML has it, and
through PyYAML's pure-Python safe classes where libyaml would give other
text or other objects.  These tests hold ``dcop_yaml`` byte for byte and
``load_dcop`` error for error to the JAX package, which uses
``yaml.safe_load`` and ``yaml.safe_dump`` throughout.
"""

import numpy as np
import pytest
import yaml

from pydcop_tpu.dcop.yamldcop import dcop_yaml as jax_dcop_yaml
from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load_dcop
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop

INTENTION = """\
name: multi-line
objective: min
domains:
  d:
    values: [0, 1, 2]
variables:
  v1: {domain: d}
  v2: {domain: d}
constraints:
  c:
    type: intention
    function: |
      if v1 == v2:
          return 10 + 0.5 * v1 + 0.25 * v2 + 0.125 * v1 * v2
      else:
          return 0.0 + 0.001 * v1
"""

# printable ASCII, and what makes a scalar double-quoted
_ALPHABET = [chr(c) for c in range(0x20, 0x7F)] + [
    "\n", "\t", "\r", "\x07", "é", "ü", "λ", "  ",
]


def _random_strings(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        size = int(rng.integers(1, 200))
        out.append("".join(rng.choice(_ALPHABET, size=size)))
    return out


def _problem_text(description, values):
    return yaml.safe_dump(
        {
            "name": "random",
            "objective": "min",
            "description": description,
            "domains": {"d": {"values": values}},
            "variables": {"v1": {"domain": "d"}, "v2": {"domain": "d"}},
            "constraints": {
                "c": {"type": "intention", "function": "0 if v1 == v2 else 1"}
            },
        },
        default_flow_style=False,
        sort_keys=False,
    )


def test_multi_line_intention_dumps_like_jax():
    port = dcop_yaml(load_dcop(INTENTION))
    jax = jax_dcop_yaml(jax_load_dcop(INTENTION))
    assert port == jax
    # the body's double-quoted line is wider than libyaml folds alike
    assert '"' in port and len(max(port.splitlines(), key=len)) > 60


@pytest.mark.parametrize("seed", range(4))
def test_random_strings_dump_like_jax(seed):
    strings = _random_strings(80, seed)
    for i in range(0, len(strings), 4):
        text = _problem_text(strings[i], list(dict.fromkeys(strings[i + 1:i + 4])))
        port_dcop, jax_dcop = load_dcop(text), jax_load_dcop(text)
        assert port_dcop.description == jax_dcop.description
        assert list(port_dcop.domains["d"].values) == list(
            jax_dcop.domains["d"].values)
        assert dcop_yaml(port_dcop) == jax_dcop_yaml(jax_dcop)


@pytest.mark.parametrize("seed", range(2))
def test_random_ascii_strings_dump_like_jax(seed):
    # no double-quoted scalar: libyaml writes the text
    rng = np.random.default_rng(100 + seed)
    ascii_ = [chr(c) for c in range(0x20, 0x7F) if chr(c) != '"']
    for _ in range(40):
        words = ["".join(rng.choice(ascii_, size=int(rng.integers(1, 150))))
                 for _ in range(4)]
        text = _problem_text(words[0], list(dict.fromkeys(words[1:])))
        assert dcop_yaml(load_dcop(text)) == jax_dcop_yaml(jax_load_dcop(text))


def test_tab_in_a_plain_scalar_is_refused_like_jax():
    text = INTENTION.replace(
        "    function: |\n", "    function: 10 if v1 ==\tv2 else 0\n"
    ).split("      if v1")[0]
    with pytest.raises(yaml.YAMLError) as jax_error:
        jax_load_dcop(text)
    with pytest.raises(yaml.YAMLError) as port_error:
        load_dcop(text)
    assert type(port_error.value) is type(jax_error.value)
    assert type(jax_error.value) is yaml.scanner.ScannerError


def test_tab_in_a_quoted_scalar_loads_like_jax():
    text = INTENTION.replace(
        "    function: |\n", '    function: "10 if v1 ==\tv2 else 0"\n'
    ).split("      if v1")[0]
    port, jax = load_dcop(text), jax_load_dcop(text)
    assert port.constraints["c"].expression == jax.constraints["c"].expression
    assert dcop_yaml(port) == jax_dcop_yaml(jax)
