"""The one traffic generator: an open-loop arrival schedule in wall-clock
seconds, read from a mix file (``mixes/<name>.json``) and a cell's rate.

Shaped after the port's ``frontend/traces.py`` (a Poisson base load,
seeded lengths and prompt ids), but in seconds instead of scheduler steps.
The seed draws the trace: the order of the lengths, the order of the
inter-arrival gaps and the token ids. What it draws from is one set for
every seed, so that every seed does the same work in another order:

* the request count follows from the rate and the horizon alone;
* prompt and output lengths are the distribution's quantiles at
  ``(i + 0.5) / n`` (lognormal, clipped), each list shuffled by the seed;
* the unit-rate inter-arrival gaps are the exponential's quantiles,
  shuffled by the seed, over the cell's rate;
* token ids are uniform over the vocabulary.

The same seed gives the same schedule, token for token.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    idx: int
    due: float  # seconds after the traffic starts
    prompt: np.ndarray  # int32 token ids
    max_new_tokens: int


def length_quantiles(spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of ``spec``'s lognormal
    distribution, clipped to [min, max], ascending."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    u = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def unit_gaps(n: int) -> np.ndarray:
    """Unit-rate exponential inter-arrival gaps at the quantiles (i + 0.5) / n."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u)


def request_count(rate: float, horizon_s: float) -> int:
    """Requests a schedule holds: the expected arrivals over the horizon,
    with room for the run's tail."""
    return int(math.ceil(rate * horizon_s * 1.15)) + 8


def schedule(mix: Dict, rate: float, horizon_s: float, seed: int, vocab: int,
             max_seq_len: int) -> List[Arrival]:
    """The run's arrivals, sorted by due time. A prompt and its output have
    to fit ``max_seq_len``."""
    kind = mix.get("arrivals", {}).get("kind", "poisson")
    if kind != "poisson":
        raise ValueError(f"unknown arrival kind {kind!r}")
    n = request_count(rate, horizon_s)
    rng = np.random.default_rng([int(seed), 3])
    prompts = rng.permutation(length_quantiles(mix["prompt_tokens"], n))
    outputs = rng.permutation(length_quantiles(mix["output_tokens"], n))
    if int((prompts + outputs).max()) > max_seq_len:
        raise ValueError(f"mix {mix['name']}: a prompt and its output exceed max_seq_len "
                         f"{max_seq_len}")
    due = np.cumsum(rng.permutation(unit_gaps(n))) / rate
    ids = np.random.default_rng(int(seed)).integers(0, vocab, size=int(prompts.sum()),
                                                    dtype=np.int64).astype(np.int32)
    cuts = np.concatenate([[0], np.cumsum(prompts)])
    return [Arrival(i, float(due[i]), ids[cuts[i]:cuts[i + 1]], int(outputs[i]))
            for i in range(n)]
