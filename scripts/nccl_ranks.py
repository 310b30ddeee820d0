"""Phase 4m (d) of chip_smoke.py alone, on a host with several cards: the
port's dry run and 4l (e)'s mega-bundle over nccl, one rank per card (at
most 4), the mega-bundle held against the one-process mesh of as many
shards; the stage overlap (run_pipeline(mesh=make_mesh(), overlap=True)
on chip_smoke.py's 80-frame scene under SlamConfig()) over nccl on 2 and
on 4 cards, one rank per card, each against the one-process overlap on a
mesh of as many shards, with the overlapped stage's seconds per rank;
then kernels B1, B2 and B6 on cuda:1 against their plain versions.
chip_smoke.py runs the same checks itself only where the host has more
than one card.

    python3 scripts/nccl_ranks.py

Exits non-zero where the host has fewer than two cards or a check fails.
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("nccl_ranks: needs two CUDA cards or more")
        return 1
    from slam_tpu_torch.config import SlamConfig
    from slam_tpu_torch.ops import cuda_kernels as ck
    from slam_tpu_torch.utils import synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(card, torch.cuda.device_count(), flush=True)
    ck.build()
    # chip_smoke.py's scene
    scene = synthetic.make_scene(seed=cs.SEED, num_frames=80,
                                 num_landmarks=8000, trajectory="loop",
                                 hw=cs.HW)
    L, R = synthetic.render_sequence(scene)
    mega = synthetic.megaproblem(scene.calib, cs.MEGA["P"], cs.MEGA["L"],
                                 cs.MEGA["obs_per_lm"], cs.SEED)
    print(cs.nccl_ranks(ck, mega, scene.calib, L, R, scene, SlamConfig(),
                        card[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
