"""``pio-torch eval`` in both lanes against the JAX package's ``pio eval``,
on the CPU, over memory stores that hold the same events.

- ``eval --grid --device cpu``: exit 0 and a leaderboard whose structure
  equals the JAX one (board and row keys, rows, each config's params,
  ``diverged``, the winner's full ``engineParams`` shape); the numbers
  differ, as the factor inits do. A bad grid file gives the JAX
  ``[ERROR]`` lines, line for line, and exit 1. The winner's
  ``engineParams`` trains through the port's ``create_workflow``.
- ``eval <module:Evaluation> --device cpu`` with the template's
  ``RecommendationEvaluation`` through a factory naming the app: exit 0,
  ``best.json`` in the working directory, an ``EVALCOMPLETED``
  evaluation instance; with a generator of its own and no
  ``best.json`` (``engine_metrics``), the same; bad class paths fail
  with one ``[ERROR]``.
- Without ``--device`` both lanes run on cuda, and raise here.
"""

import datetime as dt
import json

import numpy as np
import pytest
import torch

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.tools import cli as jcli
from predictionio_tpu_torch.controller import EngineParams, EngineParamsGenerator
from predictionio_tpu_torch.controller.evaluation import Evaluation
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.ops.als import ALSParams
from predictionio_tpu_torch.templates.recommendation import engine as teng
from predictionio_tpu_torch.tools import cli as tcli

UTC = dt.timezone.utc
PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")
APP = "tuneapp"


def seed_app(pkg, st, n_users=24, n_items=12):
    import importlib

    base = importlib.import_module(f"{pkg}.data.storage.base")
    Event = importlib.import_module(f"{pkg}.data.event").Event
    aid = st.get_metadata_apps().insert(base.App(0, APP))
    rng = np.random.default_rng(4)
    t0 = dt.datetime(2021, 1, 1, tzinfo=UTC)
    st.get_levents().init(aid)
    st.get_levents().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item",
              target_entity_id=f"i{rng.integers(0, n_items)}",
              properties={"rating": float(rng.integers(1, 6))},
              event_time=t0 + dt.timedelta(minutes=j))
        for u in range(n_users) for j in range(6)], aid)


@pytest.fixture
def stores(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for pkg, st in zip(PACKAGES, (jstorage, tstorage)):
        st.reset(st.StorageConfig(
            sources={"S": {"type": "memory"}},
            repositories={r: "S" for r in ("METADATA", "EVENTDATA",
                                           "MODELDATA")}))
        seed_app(pkg, st)
    yield tmp_path
    jstorage.reset()
    tstorage.reset()


def grid_file(path, **over):
    spec = {"base": {"rank": 4, "numIterations": 2, "seed": 1},
            "configs": [{"lambda": 0.05}, {"lambda": 0.5}, {"rank": 2},
                        {"alpha": 1e38}],
            "data": {"appName": APP}}
    spec.update(over)
    path.write_text(json.dumps(spec))
    return str(path)


def structure(board):
    """What must match across packages: keys, rows' configs and params,
    divergence, the winner's engine params shape."""
    rows = sorted(board["rows"], key=lambda r: r["config"])
    winner = board["winner"]
    ep = winner["engineParams"]
    return {
        "keys": sorted(board),
        "metricName": board["metricName"], "k": board["k"],
        "nTestUsers": board["nTestUsers"], "gridK": board["gridK"],
        "batches": board["batches"],
        "rowKeys": [sorted(r) for r in rows],
        "params": [r["params"] for r in rows],
        "diverged": [r["diverged"] for r in rows],
        "winnerKeys": sorted(winner),
        "engineParams": {stage: sorted(ep[stage]) if stage != "algorithms"
                         else [sorted(a) for a in ep[stage]]
                         for stage in ep},
        "algoParams": sorted(ep["algorithms"][0]["params"]),
        "datasource": ep["datasource"],
    }


def test_grid_eval_board_has_the_jax_structure(stores, capsys):
    jout, tout = stores / "jax.json", stores / "port.json"
    assert jcli.main(["eval", "--grid", grid_file(stores / "g.json"),
                      "--grid-out", str(jout), "--topk", "5"]) == 0
    capsys.readouterr()
    assert tcli.main(["eval", "--grid", grid_file(stores / "g.json"),
                      "--grid-out", str(tout), "--topk", "5",
                      "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "winner: config" in printed
    assert "diverged configs masked out: [3]" in printed
    assert "[INFO] Kernel launches:" in printed
    jboard = json.loads(jout.read_text())
    tboard = json.loads(tout.read_text())
    assert structure(tboard) == structure(jboard)
    assert tboard["rows"][-1]["config"] == 3
    assert tboard["rows"][-1]["metric"] is None
    winner = tboard["winner"]
    algo = winner["engineParams"]["algorithms"][0]
    assert algo["name"] == "als"
    assert algo["params"]["lambda_"] == winner["params"]["lambda"]
    assert algo["params"]["rank"] == winner["params"]["rank"]


def test_the_winner_trains_through_create_workflow(stores, capsys):
    out = stores / "board.json"
    assert tcli.main(["eval", "--grid", grid_file(stores / "g.json"),
                      "--grid-out", str(out), "--device", "cpu"]) == 0
    ep = json.loads(out.read_text())["winner"]["engineParams"]
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.workflow.create_workflow import (
        WorkflowConfig,
        create_workflow,
    )

    variant = {"datasource": ep["datasource"],
               "preparator": ep["preparator"],
               "algorithms": ep["algorithms"], "serving": ep["serving"]}
    iid = create_workflow(
        WorkflowConfig(engine_factory="predictionio_tpu_torch.templates."
                                      "recommendation.engine:engine_factory"),
        variant=variant, ctx=ComputeContext(device="cpu"))
    instance = tstorage.get_metadata_engine_instances().get(iid)
    assert instance.status == "COMPLETED"


BAD_GRIDS = {
    "fields": {"configs": [{"lambda": 0.1, "typo_field": 1}, {"seed": 9}]},
    "section": {"gird": "oops"},
    "no app": {"data": {}},
    "empty": {"configs": []},
    "base": {"base": {"frobnicate": 1}},
}


@pytest.mark.parametrize("name", sorted(BAD_GRIDS) + ["unreadable",
                                                       "not an object"])
def test_bad_grid_files_give_the_jax_error_lines(stores, capsys, name):
    path = stores / "g.json"
    if name == "unreadable":
        arg = str(stores / "missing.json")
    elif name == "not an object":
        path.write_text("[1, 2]")
        arg = str(path)
    else:
        arg = grid_file(path, **BAD_GRIDS[name])
    assert jcli.main(["eval", "--grid", arg]) == 1
    want = capsys.readouterr().err.splitlines()
    assert tcli.main(["eval", "--grid", arg, "--device", "cpu"]) == 1
    got = capsys.readouterr().err.splitlines()
    assert got == want and got and all(ln.startswith("[ERROR]")
                                       for ln in got)


def test_grid_eval_on_a_missing_app_fails(stores, capsys):
    arg = grid_file(stores / "g.json", data={"appName": "ghost"})
    assert tcli.main(["eval", "--grid", arg, "--device", "cpu"]) == 1
    assert "[ERROR] cannot read events for app 'ghost'" in \
        capsys.readouterr().err


# -- the Evaluation lane ---------------------------------------------------------------

def make_evaluation():
    """The template's Evaluation over the test app, at a small rank."""
    return teng.RecommendationEvaluation(app_name=APP, k=5)


class SmallGrid(EngineParamsGenerator):
    def __init__(self):
        super().__init__()
        self.engine_params_list = [
            EngineParams(
                data_source_params=("", teng.DataSourceParams(app_name=APP)),
                algorithm_params_list=[("als", ALSParams(
                    rank=r, num_iterations=2, seed=0, lambda_=lam))])
            for r, lam in ((2, 0.1), (4, 0.1), (4, 0.1))]


class NoBestJson(Evaluation):
    def __init__(self):
        super().__init__()
        self.engine_metrics = (teng.engine_factory(), teng.PrecisionAtK(5),
                               [teng.NDCGAtK(5)])


def evaluation_instances():
    return tstorage.get_metadata_evaluation_instances().get_all()


def test_evaluation_lane_writes_best_json_and_the_instance(stores, capsys):
    assert tcli.main(["eval", f"{__name__}:make_evaluation",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[INFO] Best Params Index:" in out
    best = json.loads((stores / "best.json").read_text())
    assert best["engineFactory"].endswith(":RecommendationEvaluation")
    assert best["algorithms"][0]["params"]["rank"] in (8, 16)
    assert best["datasource"]["params"]["app_name"] == APP
    [inst] = evaluation_instances()
    assert inst.status == "EVALCOMPLETED"
    assert inst.evaluation_class == f"{__name__}:make_evaluation"
    result = json.loads(inst.evaluator_results_json)
    assert result["metricHeader"] == "Precision@5"
    assert len(result["engineParamsScores"]) == 4
    assert inst.evaluator_results.startswith("Best Params Index:")


def test_evaluation_lane_with_a_generator_ties_keep_the_first(stores,
                                                              capsys):
    assert tcli.main(["eval", f"{__name__}:NoBestJson",
                      f"{__name__}:SmallGrid", "--device", "cpu"]) == 0
    assert not (stores / "best.json").exists()
    [inst] = evaluation_instances()
    assert inst.engine_params_generator_class == f"{__name__}:SmallGrid"
    result = json.loads(inst.evaluator_results_json)
    scores = [s["score"] for s in result["engineParamsScores"]]
    # configs 1 and 2 are the same params: the later never wins a tie
    assert scores[1] == scores[2] and result["bestIdx"] != 2
    assert result["otherMetricHeaders"] == ["NDCG@5"]


@pytest.mark.parametrize("argv", [
    ["eval"],
    ["eval", "nomodule_here:nothing"],
    ["eval", f"{__name__}:SmallGrid"],
    ["eval", f"{__name__}:NoBestJson"],
    ["eval", f"{__name__}:NoBestJson", f"{__name__}:NoBestJson"],
], ids=["nothing", "no module", "not an Evaluation", "no params",
        "not a generator"])
def test_evaluation_lane_refusals(stores, capsys, argv):
    assert tcli.main(argv + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("[ERROR]") and len(err.splitlines()) == 1
    assert evaluation_instances() == []


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
@pytest.mark.parametrize("lane", ["grid", "evaluation"])
def test_eval_defaults_to_cuda_and_raises_without_it(stores, lane):
    argv = (["eval", "--grid", grid_file(stores / "g.json")]
            if lane == "grid" else ["eval", f"{__name__}:make_evaluation"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(argv)
