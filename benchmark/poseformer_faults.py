"""Faults planted in the program's PoseFormer, for the cell
``video-train-poseformer``, beside those of ``benchmark/faults.py`` that
its runner can take, and its calibration:

    python3 -m benchmark.poseformer_faults --workload video-train-poseformer \\
        --seeds 1,2,3 --faults temporal_head_zeroed --fault_seeds 4,5,6 \\
        --control_seeds 7,8,9 [--out FILE]

runs ``benchmark.calibrate`` (same flags, same readings) with
:data:`FAULTS` known as the faults of the cell's runner.
"""
from __future__ import annotations

import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import calibrate, faults  # noqa: E402


def _on_each_poseformer(setattr, mark) -> None:
    """``mark(net)`` on every PoseFormer the program builds from now on."""
    from dhaug_torch.models import posenets

    init = posenets.PoseFormer.__init__

    def init_and_mark(self, *args, **kwargs):
        init(self, *args, **kwargs)
        mark(self)

    setattr(posenets.PoseFormer, "__init__", init_and_mark)


def temporal_head_zeroed(spec, setattr) -> None:
    """The last temporal block's attention puts out zeros for its first
    head: one of 32 heads of the temporal transformer is lost."""

    def mark(net):
        attn = net.blocks[-1].attn
        width = attn.proj.in_features // attn.num_heads

        def zero_first_head(module, inputs):
            heads = inputs[0].clone()
            heads[..., :width] = 0.0
            return (heads,)

        attn.proj.register_forward_pre_hook(zero_first_head)

    _on_each_poseformer(setattr, mark)


def spatial_block_skipped(spec, setattr) -> None:
    """The last spatial block passes its input through unchanged (and
    draws no stochastic depth mask)."""

    def mark(net):
        net.Spatial_blocks[-1].forward = lambda x, generator=None: x

    _on_each_poseformer(setattr, mark)


FAULTS = {name: faults.TRAINING[name] for name in ("state_unchanged", "half_batch",
                                                   "motion_half_batch", "altered",
                                                   "altered_2d")}
FAULTS.update(temporal_head_zeroed=temporal_head_zeroed,
              spatial_block_skipped=spatial_block_skipped)
RUNNER = "video_poseformer"


def main(argv=None) -> int:
    with faults.Patches() as p:
        p.setattr(faults, "BY_RUNNER", {**faults.BY_RUNNER, RUNNER: FAULTS})
        return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
