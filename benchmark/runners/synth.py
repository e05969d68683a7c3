"""Runner of bulk pose synthesis: each chunk is K dispatches of
``synthesize_dataset.synth_pairs`` (the generator trunk, kernel B3 on the
card; the bone scalers; the FK, kernel B1; one random training camera and
the distorted projection) at the traffic's batch, dispatched ahead and
synchronized once at the chunk's end.  The outputs stay on the device; the
npz write of the CLI is not measured.  One dispatch a window chunk, drawn
from the seed, is kept for the check."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import follow
from benchmark.reference import geometry as geo
from benchmark.reference.cameras import camera_bank
from benchmark.reference.nets import init_weights
from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
from dhaug_torch.models.trunk_cuda import trunk_weights
from dhaug_torch.parallel.sharded import make_sharded_synthesizer
from dhaug_torch.synthesize_dataset import synth_pairs


def setup(run, config: dict, traffic: dict) -> dict:
    cfg = GeneratorConfig(dense_dim=config["gan"]["gen_dense"])
    torch.manual_seed(run.seeds[0])
    net = FkGeneratorNet(cfg).to(run.device).eval()
    init_weights([net], follow.pool_mod.torch_generator(run.device, run.seeds[0]))
    state = {"ops": trunk_weights(net), "synthesize": make_sharded_synthesizer(cfg, 1),
             "cameras": camera_bank(run.device),
             "bones": follow.synth_bones(config, run.seeds, traffic["batch"], run.device),
             "chunk": 0, "kept": [], "keep": False, "traffic": traffic, "config": config}
    for _ in range(traffic.get("warmup_chunks", 1)):
        chunk(state, run)
    state["keep"] = True
    return state


def kept_dispatch(seed: int, chunk_index: int, k: int) -> int:
    return int(np.random.default_rng([abs(seed), chunk_index]).integers(0, k))


def chunk(state: dict, run) -> dict:
    c, K = state["chunk"], state["traffic"]["chunk_batches"]
    state["chunk"] += 1
    g = follow.pool_mod.torch_generator(run.device, follow.chunk_seed(run.seeds[4], c))
    keep = kept_dispatch(run.seed, c, K) if state["keep"] else -1
    with run.span("synth"):
        for d in range(K):
            out = synth_pairs(state["synthesize"], state["ops"], state["bones"],
                              state["cameras"], g)
            if d == keep:
                state["kept"].append(((c, d), out))
    B = state["traffic"]["batch"]
    return {"counts": {"units": K, "dispatches": K, "poses": K * B}}


def check(state: dict, run) -> dict:
    """Free the program's weights, recompute the kept dispatches with the
    reference, and return the gaps."""
    kept, config, traffic = state["kept"], state["config"], state["traffic"]
    state.clear()
    reference = follow.synth_rows(config, traffic, run.seeds, run.device, [k for k, _ in kept])
    return checks.synthesis_gaps([rows for _, rows in kept], reference,
                                 geo.bone_lengths_fk, geo.project_to_2d)


def control(config: dict, traffic: dict, seeds: list, device) -> dict:
    """The control's gaps: the reference with an fp8 trunk against the
    reference, on two dispatches."""
    samples = [(1, 0), (2, traffic["chunk_batches"] - 1)]
    ref = follow.synth_rows(config, traffic, seeds, device, samples)
    low = follow.synth_rows(config, traffic, seeds, device, samples, "fp8")
    return checks.synthesis_gaps([r[:3] for r in low], ref, geo.bone_lengths_fk,
                                 geo.project_to_2d)
