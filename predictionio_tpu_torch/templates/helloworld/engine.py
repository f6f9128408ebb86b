"""Hello-world engine: the canonical L-flavor (local) template.

The port's copy of ``predictionio_tpu/templates/helloworld/engine.py``.

Capability parity with the reference's
``examples/experimental/scala-local-helloworld/HelloWorld.scala``:

- ``MyDataSource extends LDataSource`` reads a ``day,temperature`` CSV
  on the HOST (no device involved — the whole point of the L
  flavor, ``LDataSource.scala:37-71``)
- ``MyAlgorithm extends LAlgorithm`` computes the average temperature
  per day; the model is a plain host dict
- ``predict`` looks the queried day up in the model
- wired through ``SimpleEngine`` (one datasource + one algorithm,
  identity preparator, first-serving — ``EngineParams.scala:127-147``)

This is the template that exercises LDataSource/LAlgorithm through the
full train -> persist -> deploy -> query lifecycle (the reference runs
it with ``pio train``/``deploy`` like any parallel engine).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.controller import (
    LAlgorithm,
    LDataSource,
    Params,
    SimpleEngine,
)


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    """Path of the ``day,temperature`` CSV (the reference hard-codes
    ``../data/helloworld/data.csv``; a param keeps the template
    deployable from any directory)."""

    data_path: str = "data.csv"


@dataclasses.dataclass
class TrainingData:
    """(day, temperature) tuples (MyTrainingData)."""

    temperatures: List[Tuple[str, float]]

    def sanity_check(self) -> None:
        assert self.temperatures, (
            "temperatures cannot be empty — check the data file")


@dataclasses.dataclass(frozen=True)
class Query:
    day: str = ""


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    temperature: Optional[float]


@dataclasses.dataclass
class HelloWorldModel:
    """day -> average temperature (MyModel)."""

    temperatures: Dict[str, float]

    def __str__(self) -> str:
        return str(self.temperatures)


class HelloWorldDataSource(LDataSource):
    """MyDataSource: parse the CSV host-side (HelloWorld.scala:28-42)."""

    params_class = DataSourceParams

    def read_training(self) -> TrainingData:
        p: DataSourceParams = self.params
        rows: List[Tuple[str, float]] = []
        with open(p.data_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                day, temp = line.split(",")
                rows.append((day, float(temp)))
        return TrainingData(rows)


class HelloWorldAlgorithm(LAlgorithm):
    """MyAlgorithm: average per day (HelloWorld.scala:44-66)."""

    query_cls = Query

    def train(self, td: TrainingData) -> HelloWorldModel:
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for day, temp in td.temperatures:
            sums[day] = sums.get(day, 0.0) + temp
            counts[day] = counts.get(day, 0) + 1
        return HelloWorldModel(
            {day: sums[day] / counts[day] for day in sums})

    def predict(self, model: HelloWorldModel,
                query: Query) -> PredictedResult:
        # the reference throws on an unknown day (HashMap.apply);
        # serving surfaces that as an error — mirror with None->explicit
        if query.day not in model.temperatures:
            raise KeyError(f"day {query.day!r} not in model")
        return PredictedResult(temperature=model.temperatures[query.day])


def engine_factory() -> SimpleEngine:
    """MyEngineFactory (HelloWorld.scala:69-79)."""
    return SimpleEngine(HelloWorldDataSource, HelloWorldAlgorithm)
