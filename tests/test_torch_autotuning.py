"""The port's autotuning plane against the JAX package's, on the CPU
(``deepspeed_tpu_torch/autotuning/``, ``models/simple.py``, the engine's
fingerprint check).

The same inputs go through both packages and must give the same outputs,
exactly, except the SimpleModel trajectory (fp32, relative 1e-5):

* ``gen_combinations``, ``flatten`` and ``dict_to_feature`` on nested
  spaces; ``SearchSpace.enumerate`` (cids, patches, knobs, the env and
  config split) on the default space and on guarded ones; ``apply_patch``
  and ``patch_diff``;
* ``score_from_efficiency`` and ``better`` on the same ``EFFICIENCY.json``
  documents (conserving, non-conserving, without ``mfu``, malformed);
* the grid, random and model-based tuners' order and best with a synthetic
  metric; ``Autotuner._experiments``, ``_feasible_stages`` and ``tune``;
* ``ClosedLoopAutotuner`` over a stub scheduler: the same pruned set and
  reasons, the same best, the same manifest but for the fingerprint and
  the paths;
* fingerprint ``compare``, ``check`` under each policy, and
  ``fingerprint_digest``;
* the engines' check at build on the tiny GPT (the repaired fault: the
  port took an ``autotuning`` block and ignored it);
* SimpleModel's loss and 6 Adam steps from converted weights.

The port refuses a kernel knob that lists ``"0"`` (JAX's plain path).
"""

import json
import os
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.autotuning import autotuner as j_autotuner
from deepspeed_tpu.autotuning import fingerprint as j_fp
from deepspeed_tpu.autotuning import loop as j_loop
from deepspeed_tpu.autotuning import scheduler as j_sched
from deepspeed_tpu.autotuning import scoring as j_scoring
from deepspeed_tpu.autotuning import space as j_space
from deepspeed_tpu.autotuning import tuner as j_tuner
from deepspeed_tpu.autotuning import utils as j_utils
from deepspeed_tpu.models.gpt import GPT as JGPT
from deepspeed_tpu.models.gpt import GPTConfig as JGPTConfig
from deepspeed_tpu.models.simple import SimpleModel as JSimpleModel
from deepspeed_tpu.models.simple import random_dataset as j_random_dataset
from deepspeed_tpu_torch.autotuning import autotuner as t_autotuner
from deepspeed_tpu_torch.autotuning import fingerprint as t_fp
from deepspeed_tpu_torch.autotuning import loop as t_loop
from deepspeed_tpu_torch.autotuning import scheduler as t_sched
from deepspeed_tpu_torch.autotuning import scoring as t_scoring
from deepspeed_tpu_torch.autotuning import space as t_space
from deepspeed_tpu_torch.autotuning import tuner as t_tuner
from deepspeed_tpu_torch.autotuning import utils as t_utils
from deepspeed_tpu_torch.models.convert import simple_params_from_jax
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.models.simple import SimpleModel, random_dataset

PACKAGES = {"jax": (j_utils, j_space, j_scoring, j_tuner, j_autotuner, j_loop, j_sched, j_fp),
            "torch": (t_utils, t_space, t_scoring, t_tuner, t_autotuner, t_loop, t_sched, t_fp)}


def both(fn):
    """``fn(modules)`` for each package: (the JAX package's, the port's)."""
    return fn(dict(zip(("utils", "space", "scoring", "tuner", "autotuner", "loop", "sched",
                        "fp"), PACKAGES["jax"]))), \
        fn(dict(zip(("utils", "space", "scoring", "tuner", "autotuner", "loop", "sched", "fp"),
                    PACKAGES["torch"])))


# --------------------------------------------------------------------------- #
# utils, space, patches
# --------------------------------------------------------------------------- #
SPACES = [
    {"a": [1, 2], "b": {"c": [3, 4], "d": 5}},
    {"train_micro_batch_size_per_gpu": [1, 2, 4],
     "zero_optimization": {"stage": 3, "offload_param": [None, {"device": "cpu"}]}},
    {"x": {"y": {"z": [True, False]}, "w": "cpu"}, "v": 7},
]


@pytest.mark.parametrize("space", SPACES)
def test_utils_match_jax(space):
    j, t = both(lambda m: (m["utils"].gen_combinations(space), m["utils"].flatten(space),
                           m["utils"].flatten(space, sep=".")))
    assert j == t
    flat = j[1]
    keys = sorted(flat) + ["missing"]
    assert j_utils.dict_to_feature(flat, keys) == t_utils.dict_to_feature(flat, keys)
    nested_j, nested_t = {}, {}
    for path, v in sorted(j_utils.flatten(space, sep=".").items()):
        j_utils.set_nested(nested_j, path, v)
        t_utils.set_nested(nested_t, path, v)
    assert nested_j == nested_t


def candidates(space_mod, knobs):
    space = (space_mod.SearchSpace.from_config({}) if knobs is None
             else space_mod.SearchSpace(knobs))
    return ([k.name for k in space.knobs],
            [(c.cid, c.patch, c.knobs, c.env(), c.config_patch(), c.key())
             for c in space.enumerate()])


@pytest.mark.parametrize("knobs", [
    None,                                   # the default space
    {"zero_stage": (1, 3), "micro_batch": (1, 4), "qwz": (False, True)},
    {"zero_stage": (1, 2, 3), "qwz": (False, True), "qwz_bits": (8, 4),
     "qgz": (False, True), "hpz_partition_size": (1, 2)},
    {"zero_stage": (3,), "offload_param": (None, "cpu", "nvme"),
     "offload_optimizer": (None, "cpu"), "micro_batch": (2, 8)},
    {"mesh_shape": ({"data": 8}, {"data": 4, "fsdp": 2}), "gas": (1, 2),
     "prefetch_depth": (1, 4), "hbm_budget_bytes": (0, 1 << 30)},
    {"pallas_ce": ("1",), "pallas_fused_opt": ("1",), "zero_stage": (3,),
     "serve_num_blocks": (128, 256), "serve_prefill_chunk": (32,)},
], ids=["default", "qwz-guard", "zeropp-guards", "offload", "mesh", "kernel-env"])
def test_search_space_enumerates_as_jax(knobs):
    j, t = both(lambda m: candidates(m["space"], knobs))
    assert j == t and j[1]


def test_search_space_refusals_match():
    for bad in ({"zero_stag": (1, 3)}, {"zero_stage": ()}):
        errs = both(lambda m: pytest.raises(m["space"].UnknownKnobError,
                                            m["space"].SearchSpace, bad).value)
        assert str(errs[0]) == str(errs[1])
    assert [k.name for k in j_space.KNOB_CATALOG] == [k.name for k in t_space.KNOB_CATALOG]
    for jk, tk in zip(j_space.KNOB_CATALOG, t_space.KNOB_CATALOG):
        assert (jk.path, jk.values, jk.kind, jk.only_if) == (tk.path, tk.values, tk.kind,
                                                             tk.only_if)


@pytest.mark.parametrize("values", [("0", "1"), ("0",), (0,)])
@pytest.mark.parametrize("knob", ["pallas_ce", "pallas_fused_opt"])
def test_kernel_knob_plain_path_is_refused(knob, values):
    """JAX's "0" picks XLA's plain path; the port has none on the card, so
    it refuses the axis instead of tuning nothing."""
    assert j_space.SearchSpace({knob: values}).enumerate()       # JAX takes it
    with pytest.raises(t_space.PlainPathKnobError, match="no plain path") as err:
        t_space.SearchSpace({knob: values})
    assert isinstance(err.value, ValueError)
    (cand,) = t_space.SearchSpace({knob: ("1",)}).enumerate()
    assert cand.env() == {t_space.KNOB_CATALOG[[k.name for k in t_space.KNOB_CATALOG]
                                               .index(knob)].path[len("env."):]: "1"}


@pytest.mark.parametrize("base,patch", [
    ({"train_micro_batch_size_per_gpu": 1, "zero_optimization": {"stage": 1}},
     {"zero_optimization.stage": 3, "train_micro_batch_size_per_gpu": 4,
      "env.DST_PALLAS_CE": "1"}),
    ({"mesh": {"data": 8}}, {"mesh": {"data": 4, "model": 2}}),
    ({}, {"zero_optimization.offload_param.device": "cpu", "a.b.c": [1, 2]}),
    ({"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}}},
     {"zero_optimization.offload_param.device": "cpu", "gradient_accumulation_steps": 2}),
])
def test_apply_patch_and_diff_match(base, patch):
    before = json.dumps(base, sort_keys=True)
    j, t = both(lambda m: (m["space"].apply_patch(base, patch),
                           m["space"].patch_diff(base, patch)))
    assert j == t
    assert json.dumps(base, sort_keys=True) == before


# --------------------------------------------------------------------------- #
# scoring
# --------------------------------------------------------------------------- #
def _ledger(goodput=0.9, wall=2.0, steps=4, mfu=0.3, ok=True, **extra):
    led = {"categories": {"productive": wall * goodput, "hang": wall * (1 - goodput)},
           "goodput_frac": goodput, "wall_s": wall, "steps": steps,
           "productive_steps": steps, "conservation": {"ok": ok}, "mode": "train"}
    if mfu is not None:
        led["mfu"] = mfu
    led.update(extra)
    return led


EFFICIENCY_DOCS = {
    "conserving": {"schema": 1, "ledger": _ledger()},
    "no-mfu": {"schema": 1, "ledger": _ledger(goodput=0.9, mfu=None, wall=1.5)},
    "mfu-null": {"ledger": dict(_ledger(goodput=0.9, mfu=None, wall=2.5), mfu=None)},
    "non-conserving": {"ledger": _ledger(goodput=0.99, ok=False)},
    "bare-ledger": _ledger(goodput=0.7, steps=0),
    "low-goodput": {"ledger": _ledger(goodput=0.4, mfu=None)},
    "no-goodput": {"ledger": {"categories": {}, "wall_s": 1.0}},
    "no-categories": {"ledger": {"goodput_frac": 0.5}},
    "malformed": {"ledger": dict(_ledger(), wall_s="fast")},
    "not-a-dict": [1, 2, 3],
}


@pytest.fixture(scope="module")
def efficiency_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("efficiency")
    paths = {}
    for name, doc in EFFICIENCY_DOCS.items():
        paths[name] = str(root / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(doc, f)
    paths["unreadable"] = str(root / "missing.json")
    with open(root / "garbage.json", "w") as f:
        f.write("{not json")
    paths["garbage"] = str(root / "garbage.json")
    return paths


def test_scores_match_jax(efficiency_paths):
    scores = {}
    for name, path in efficiency_paths.items():
        j, t = both(lambda m: m["scoring"].score_from_efficiency(path))
        assert (asdict(j[0]) if j[0] else None, j[1]) == (asdict(t[0]) if t[0] else None, t[1])
        if j[0] is not None:
            assert j[0].rank_key() == t[0].rank_key()
        scores[name] = (j[0], t[0])
    assert scores["no-mfu"][1].mfu is None and scores["conserving"][1].mfu == 0.3
    names = sorted(scores)
    for a in names + [None]:
        for b in names + [None]:
            ja, ta = scores[a] if a else (None, None)
            jb, tb = scores[b] if b else (None, None)
            assert j_scoring.better(ja, jb) == t_scoring.better(ta, tb), (a, b)


# --------------------------------------------------------------------------- #
# tuners and the seed-era autotuner
# --------------------------------------------------------------------------- #
def _exps():
    return [{"zero_optimization": {"stage": stage}, "train_micro_batch_size_per_gpu": mbs}
            for stage in (0, 1, 2) for mbs in (1, 2, 4, 8, 16, 32)]


def _metric(exp):
    mbs = exp["train_micro_batch_size_per_gpu"]
    stage = exp.get("zero_optimization", {}).get("stage", 0)
    if mbs > 16:
        return None                     # out of memory
    if mbs == 2 and stage == 2:
        raise RuntimeError("a crashed run")
    return 100 - (mbs - 16) ** 2 / 4 - 3 * abs(stage - 1)


@pytest.mark.parametrize("kind,kw,tune_kw", [
    ("GridSearchTuner", {}, {"n_trials": 100}),
    ("GridSearchTuner", {}, {"early_stopping": 3, "sample_size": 2}),
    ("RandomTuner", {"seed": 3}, {"n_trials": 100}),
    ("RandomTuner", {"seed": 11}, {"n_trials": 7, "sample_size": 3}),
    ("ModelBasedTuner", {"warmup": 4, "seed": 0}, {"n_trials": 10}),
    ("ModelBasedTuner", {"warmup": 2, "seed": 5}, {"n_trials": 12, "sample_size": 2,
                                                   "early_stopping": 6}),
])
def test_tuners_match_jax(kind, kw, tune_kw):
    def run(m):
        tuner = getattr(m["tuner"], kind)(_exps(), _metric, **kw)
        best, val = tuner.tune(**tune_kw)
        return best, val, tuner.records, tuner.rm_exps
    j, t = both(run)
    assert j == t


def test_ridge_cost_model_matches_jax():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((12, 3)).tolist()
    ys = (rng.standard_normal(12) * 10).tolist()
    jm, tm = j_tuner.RidgeCostModel(), t_tuner.RidgeCostModel()
    jm.fit(xs, ys)
    tm.fit(xs, ys)
    np.testing.assert_array_equal(jm.predict(xs), tm.predict(xs))


AUTOTUNER_CASES = {
    "synthetic": ({"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                   "autotuning": {"enabled": True, "metric": "throughput",
                                  "micro_batch_sizes": [1, 2, 4, 8, 16, 32]}},
                  dict(dp_world=8)),
    "pruned": ({"train_batch_size": 8,
                "autotuning": {"micro_batch_sizes": [1, 4, 16]}},
               dict(dp_world=8, model_info={"num_params": 100_000_000},
                    device_memory_bytes=1 << 30)),
    "limited": ({"gradient_accumulation_steps": 2, "zero_optimization": {"stage": 1,
                                                                       "offload_param": {}},
                 "autotuning": {"max_train_batch_size": 16, "zero_stages": [1, 3],
                                "tuner_type": "random", "tuner_early_stopping": 2}},
                dict(dp_world=4)),
    "model-based": ({"autotuning": {"tuner_type": "model_based", "zero_stages": [0, 3],
                                    "tuner_num_trials": 4}},
                    dict(model_info={"num_params": 10_000}, device_memory_bytes=10 ** 9)),
}


@pytest.mark.parametrize("case", sorted(AUTOTUNER_CASES))
def test_autotuner_matches_jax(case, tmp_path):
    config, kw = AUTOTUNER_CASES[case]

    def run(m):
        out = tmp_path / m["autotuner"].__name__.split(".")[0]
        at = m["autotuner"].Autotuner(config, run_fn=_metric, results_dir=str(out), **kw)
        stages = at._feasible_stages()
        exps = {s: at._experiments(s) for s in (0, 1, 2, 3)}
        mems = [at.get_instantiation_memory_required_per_device(s) for s in (0, 1, 2, 3)]
        best = at.tune()
        files = {}
        for name in ("ds_config_optimal.json", "summary.txt"):
            if (out / name).exists():
                files[name] = (out / name).read_text().replace(str(out), "<out>")
        return stages, exps, mems, best, at.best_metric_val, at.records, files
    j, t = both(run)
    assert j == t


# --------------------------------------------------------------------------- #
# the closed loop over a stub scheduler
# --------------------------------------------------------------------------- #
def _stub_scheduler(sched_mod, scoring_mod, goodputs):
    """Scores from a script: one (goodput, step time, conserving) a
    launched trial, None for a crash; past its end the last entry."""

    class Stub:
        def __init__(self):
            self.launched = []

        def run_trial(self, name, ds_config, extra_env=None, patch=None, knobs=None):
            self.launched.append((name, json.dumps(ds_config, sort_keys=True),
                                  dict(extra_env or {})))
            spec = goodputs[min(len(self.launched), len(goodputs)) - 1]
            if spec is None:
                return sched_mod.TrialResult(name=name, status=sched_mod.DEGRADED,
                                             ds_config=ds_config, patch=dict(patch or {}),
                                             knobs=dict(knobs or {}), rc=1,
                                             error="trial exited rc=1")
            gf, step, ok = spec
            score = scoring_mod.TrialScore(goodput_frac=gf, mfu=None, step_time_s=step,
                                           wall_s=4 * step, steps=4, productive_steps=4,
                                           conservation_ok=ok)
            return sched_mod.TrialResult(
                name=name, status=sched_mod.SCORED if ok else sched_mod.DEGRADED,
                ds_config=ds_config, patch=dict(patch or {}), knobs=dict(knobs or {}), rc=0,
                score=score, trial_dir=f"/trials/{name}")
    return Stub()


LOOP_CASES = {
    "offload-window": (
        {"zero_optimization": {"stage": 3},
         "autotuning": {"search_space": {"zero_stage": (3,), "offload_param": (None, "cpu"),
                                         "micro_batch": (4, 8)},
                        "model_info": {"num_params": 124_082_688, "n_layer": 12,
                                       "block_params": 7_087_872},
                        "device_memory_bytes": 2_230_000_000}},
        [(0.91, 0.2, True), (0.93, 0.1, True)], {"world": 1}, False),
    "stages-early-stop": (
        {"mesh": {"data": 8},
         "autotuning": {"search_space": {"zero_stage": (1, 2, 3), "micro_batch": (2, 4, 8),
                                         "prefetch_depth": (1, 2)},
                        "model_info": {"num_params": 1_000_000, "n_layer": 4,
                                       "block_params": 600_000},
                        "device_memory_bytes": 5_000_000, "tuner_early_stopping": 3}},
        [(0.9, 0.3, True), None, (0.95, 0.5, False), (0.9, 0.2, True), (0.8, 0.1, True),
         (0.7, 0.1, True), (0.6, 0.1, True)], {}, True),
    "default-space": (
        {"train_micro_batch_size_per_gpu": 2,
         "autotuning": {"model_info": {"num_params": 2_000_000},
                        "device_memory_bytes": 22_000_000, "tuner_num_trials": 5}},
        [(0.5, 1.0, True)] * 3 + [(0.5, 0.9, True), (0.6, 2.0, True)] + [None] * 30,
        {"world": 2}, True),
}


def _manifest_without_paths(man):
    man = json.loads(json.dumps(man))
    man.pop("fingerprint")
    man.pop("fingerprint_digest")
    for key in ("pruned", "trials"):
        for row in man[key]:
            row.pop("trial_dir", None)
    for key in ("baseline", "verification", "best"):
        if man[key]:
            man[key].pop("trial_dir", None)
    return man


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_closed_loop_matches_jax(case, tmp_path):
    config, goodputs, kw, baseline = LOOP_CASES[case]

    def run(m):
        stub = _stub_scheduler(m["sched"], m["scoring"], goodputs)
        out = tmp_path / m["loop"].__name__.split(".")[0]
        cfg = dict(config, autotuning=dict(config["autotuning"], results_dir=str(out)))
        loop = m["loop"].ClosedLoopAutotuner(cfg, scheduler=stub,
                                             fingerprint={"schema": 1, "pod": {}}, **kw)
        reasons = [(c.cid, loop.prune_reason(c)) for c in loop.space.enumerate()]
        best = loop.tune(baseline=baseline)
        loop.verify()
        patch = json.loads((out / "ds_config_patch.json").read_text()) if best else None
        if patch:
            patch["provenance"].pop("manifest")
            patch["provenance"].pop("trial_dir")
        launched = [(name, cfg_json.replace(str(out), "<out>"), env)
                    for name, cfg_json, env in stub.launched]
        return (reasons, [(r.name, r.prune_reason) for r in loop.pruned],
                best.name if best else None, launched,
                _manifest_without_paths(loop.manifest()), patch)
    j, t = both(run)
    assert j == t
    assert j[1], "the case prunes nothing"


# --------------------------------------------------------------------------- #
# fingerprints
# --------------------------------------------------------------------------- #
def _fp(**model):
    return {"schema": 1, "pod": {"device_count": 8, "process_count": 1, "platform": "cpu",
                                 "mesh_shape": {"data": 8}},
            "model": dict({"num_params": 1000}, **model), "jax_version": "0.4"}


FP_PAIRS = {
    "same": (_fp(), _fp()),
    "params": (_fp(), _fp(num_params=2000)),
    "leaner": (_fp(n_layer=12), {"model": {"num_params": 1000}}),
    "pod": (_fp(), dict(_fp(), pod={"device_count": 4096, "platform": "gpu",
                                    "mesh_shape": {"data": 1, "fsdp": 8}})),
    "only-one-side": ({"fingerprint_only": 1, "model": {"num_params": 1}},
                      {"torch_version": "2", "model": {"num_params": 39808}}),
    "type": (_fp(), dict(_fp(), pod="flat")),
}


@pytest.mark.parametrize("pair", sorted(FP_PAIRS))
def test_fingerprint_compare_and_digest_match(pair):
    stored, current = FP_PAIRS[pair]
    assert j_fp.compare(stored, current) == t_fp.compare(stored, current)
    for doc in (stored, current):
        assert j_fp.fingerprint_digest(doc) == t_fp.fingerprint_digest(doc)


@pytest.mark.parametrize("policy", ["off", "warn", "refuse"])
@pytest.mark.parametrize("pair", sorted(FP_PAIRS))
def test_fingerprint_check_policies_match(pair, policy, tmp_path):
    stored, current = FP_PAIRS[pair]
    path = tmp_path / "ds_config_patch.json"
    path.write_text(json.dumps({"fingerprint": stored, "patch": {}}))
    for doc in ({"fingerprint": stored}, str(path), str(tmp_path / "missing.json"),
                {"patch": {}}):
        got = []
        for fp_mod in (j_fp, t_fp):
            try:
                got.append(("ok", fp_mod.check(doc, current, policy=policy)))
            except fp_mod.StaleTuningError as e:
                got.append(("stale", str(e)))
        assert got[0] == got[1]
    cfgs = [{"patch": str(path)}, {"results_dir": str(tmp_path)}, {"results_dir": ""}, {}]
    for cfg in cfgs:
        assert j_fp.resolve_patch_path(cfg) == t_fp.resolve_patch_path(cfg)


def test_port_fingerprint_document():
    fp = t_fp.environment_fingerprint(mesh_shape=t_fp.data_parallel_mesh(1, 0),
                                      model_dims={"num_params": 7}, device="cpu")
    assert fp == {"schema": 1, "pod": {"device_count": 1, "process_count": 1,
                                       "platform": "cpu",
                                       "mesh_shape": {"pipe": 1, "data": 1, "fsdp": 1,
                                                      "expert": 1, "seq": 1, "tensor": 1}},
                  "model": {"num_params": 7}, "torch_version": torch.__version__}
    # the mesh the JAX engine reports for the same data-parallel run
    for stage in (0, 1, 3):
        jcfg = deepspeed_tpu.runtime.config.DeepSpeedConfig(
            {"train_batch_size": 8, "zero_optimization": {"stage": stage}})
        from deepspeed_tpu.parallel.mesh import MESH_AXES, MeshSpec
        spec = MeshSpec.from_config(jcfg, device_count=8)
        assert t_fp.MESH_AXES == MESH_AXES
        assert dict(zip(MESH_AXES, spec.shape())) == t_fp.data_parallel_mesh(8, stage)


# --------------------------------------------------------------------------- #
# the engines' check at build (the repaired fault)
# --------------------------------------------------------------------------- #
TINY = dict(vocab_size=300, n_positions=64, n_embd=32, n_layer=2, n_head=4)
ENGINE_CFG = {"train_micro_batch_size_per_gpu": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}}


@pytest.fixture(scope="module")
def tiny_gpts():
    jmodel = JGPT(JGPTConfig(dtype="float32", **TINY))
    return jmodel, jmodel.init_params(jax.random.PRNGKey(0))


def _build(which, tiny_gpts, autotuning):
    cfg = dict(ENGINE_CFG, autotuning=autotuning)
    try:
        if which == "jax":
            jmodel, params = tiny_gpts
            deepspeed_tpu.initialize(model=jmodel, model_parameters=params, config=cfg)
        else:
            model = GPT(GPTConfig(dtype="float32", **TINY), device="cpu")
            eng = dst.initialize(model=model, device="cpu", config=cfg)[0]
            assert eng.global_steps == 0
            eng.close()
    except (j_fp.StaleTuningError, t_fp.StaleTuningError) as e:
        return type(e).__name__, str(e)
    return "built", None


@pytest.mark.parametrize("where", ["patch", "results_dir", "missing"])
@pytest.mark.parametrize("policy", ["refuse", "warn", "off", None])
def test_engines_check_a_tuned_patch_at_build(tiny_gpts, tmp_path, policy, where):
    """The re-anchor's input: the tiny GPT, a patch whose fingerprint was
    tuned on ``num_params: 1``.  ``refuse`` raises the same
    ``StaleTuningError`` in both engines; ``warn`` (the default), ``off``
    and a missing file build."""
    doc = {"fingerprint": {"model": {"num_params": 1}}}
    (tmp_path / "ds_config_patch.json").write_text(json.dumps(doc))
    block = {"patch": str(tmp_path / "ds_config_patch.json"), "results_dir": str(tmp_path),
             "missing": str(tmp_path / "nope.json")}[where]
    autotuning = {"results_dir" if where == "results_dir" else "patch": block}
    if policy is not None:
        autotuning["stale_policy"] = policy
    j = _build("jax", tiny_gpts, autotuning)
    t = _build("torch", tiny_gpts, autotuning)
    assert j == t
    if policy == "refuse" and where != "missing":
        assert j[0] == "StaleTuningError"
        assert "(model.num_params: tuned on 1, now 39808)" in j[1]
    else:
        assert j == ("built", None)


def test_engine_passes_its_own_fingerprint(tmp_path):
    """A patch stamped with the live environment passes ``refuse``."""
    model = GPT(GPTConfig(dtype="float32", **TINY), device="cpu")
    fp = t_fp.environment_fingerprint(mesh_shape=t_fp.data_parallel_mesh(1, 0),
                                      model_dims={"num_params": 39808, "n_layer": 2},
                                      device="cpu")
    (tmp_path / "ds_config_patch.json").write_text(json.dumps({"fingerprint": fp}))
    eng = dst.initialize(model=model, device="cpu", config=dict(
        ENGINE_CFG, autotuning={"results_dir": str(tmp_path), "stale_policy": "refuse"}))[0]
    eng.close()
    fp["pod"]["mesh_shape"]["data"] = 2
    (tmp_path / "ds_config_patch.json").write_text(json.dumps({"fingerprint": fp}))
    with pytest.raises(t_fp.StaleTuningError, match="pod.mesh_shape.data: tuned on 2, now 1"):
        dst.initialize(model=GPT(GPTConfig(dtype="float32", **TINY), device="cpu"),
                       device="cpu", config=dict(ENGINE_CFG, autotuning={
                           "results_dir": str(tmp_path), "stale_policy": "refuse"}))


# --------------------------------------------------------------------------- #
# SimpleModel
# --------------------------------------------------------------------------- #
# fp32, both engines: losses and parameters relative 1e-5 (1e-7 absolute
# for the biases, which start at 0).  Adam moves an element by about lr
# whatever its gradient's size, so an element whose gradient is at rounding
# level at some step (|g| < ROUNDING_GRAD: a sum that cancels, as one of
# the 256 kernel entries does at the first step here, -5.9e-8 in fp64) may
# differ by up to 2 lr a step; those are held to that bound and counted.
# lr is the built-in trial's (``autotuning/trial.py``: Adam at 1e-3).
SIMPLE_RTOL, SIMPLE_ATOL = 1e-5, 1e-7
ROUNDING_GRAD = 1e-6
LR, SIMPLE_STEPS = 1e-3, 6


@pytest.mark.parametrize("nlayers", [1, 2])
def test_simple_model_trains_as_jax(nlayers):
    hidden, batch = 16, 16
    jmodel = JSimpleModel(hidden_dim=hidden, nlayers=nlayers)
    params = jmodel.init_params(jax.random.PRNGKey(3))
    sd = simple_params_from_jax(params)
    model = SimpleModel(hidden_dim=hidden, nlayers=nlayers, device="cpu")
    assert sorted(sd) == sorted(n for n, _ in model.named_parameters())
    cfg = {"train_batch_size": batch, "optimizer": {"type": "Adam", "params": {"lr": LR}}}
    jeng = deepspeed_tpu.initialize(model=jmodel, model_parameters=params, config=dict(cfg))[0]
    teng = dst.initialize(model=model, model_parameters=sd, device="cpu", config=dict(cfg))[0]
    rows = random_dataset(SIMPLE_STEPS * batch, hidden, seed=1)
    assert all(np.array_equal(a[0], b[0]) and a[1] == b[1]
               for a, b in zip(rows, j_random_dataset(SIMPLE_STEPS * batch, hidden, seed=1)))
    data = [(np.stack([r[0] for r in rows[i:i + batch]]),
             np.stack([r[1] for r in rows[i:i + batch]]))
            for i in range(0, SIMPLE_STEPS * batch, batch)]
    tiny = torch.zeros(teng._grad_flat.numel(), dtype=torch.bool)
    for x, y in data:
        jl = jeng.forward(x, y)
        jeng.backward(jl)
        jeng.step()
        tl = teng.forward(x, y)
        teng.backward(tl)
        tiny |= teng._grad_flat.abs() < ROUNDING_GRAD
        teng.step()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=SIMPLE_RTOL)
    jp = jax.tree.map(np.asarray, jeng.state.params)
    sizes = [t.numel() for _, t in model.named_parameters()]
    masks = dict(zip([n for n, _ in model.named_parameters()], torch.split(tiny, sizes)))
    for name, t in teng.get_fp32_params().items():
        layer, leaf = name.split(".")
        got, want = t.numpy(), jp[layer][leaf]
        mask = masks[name].view(got.shape).numpy()
        np.testing.assert_allclose(got[~mask], want[~mask], rtol=SIMPLE_RTOL, atol=SIMPLE_ATOL)
        assert np.all(np.abs(got[mask] - want[mask]) <= 2 * LR * SIMPLE_STEPS)
    assert int(tiny.sum()) <= 0.02 * tiny.numel()
    teng.close()


@pytest.mark.parametrize("path", ["eager", "train_batch"])
def test_engine_writes_the_experiment_metric(tmp_path, monkeypatch, path):
    """Under the autotuner (``DS_AUTOTUNING_METRIC_PATH``) each
    ``steps_per_print`` boundary writes the throughput and the step, on the
    eager ``step`` and on ``train_batch`` alike; without the variable
    nothing is written."""
    metric = tmp_path / "metrics.json"
    cfg = dict(ENGINE_CFG, steps_per_print=3, gradient_accumulation_steps=2)
    rng = np.random.default_rng(0)

    def run(steps):
        eng = dst.initialize(model=GPT(GPTConfig(dtype="float32", **TINY), device="cpu"),
                             device="cpu", config=cfg)[0]
        seen = []
        for _ in range(steps):
            ids = rng.integers(0, TINY["vocab_size"], (2, 1, 16)).astype(np.int32)
            if path == "eager":
                for i in range(2):
                    eng.backward(eng.forward(ids[i], ids[i]))
                    eng.step()
            else:
                eng.train_batch(batch=(ids, ids))
            seen.append(json.loads(metric.read_text()) if metric.exists() else None)
        eng.close()
        return seen

    assert run(2) == [None, None]
    monkeypatch.setenv(t_sched.METRIC_PATH_ENV, str(metric))
    seen = run(6)
    assert [s and s["global_steps"] for s in seen] == [None, None, 3, 3, 3, 6]
    assert seen[2]["throughput"] > 0 and seen[5]["throughput"] > 0
