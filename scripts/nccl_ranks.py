"""Phase 4m (d) of chip_smoke.py alone, on a host with several cards: the
port's dry run and 4l (e)'s mega-bundle over nccl, one rank per card (at
most 4), the mega-bundle held against the one-process mesh of as many
shards, then kernels B1, B2 and B6 on cuda:1 against their plain
versions. chip_smoke.py runs the same checks itself only where the host
has more than one card.

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
    from slam_tpu_torch.ops import cuda_kernels as ck
    from slam_tpu_torch.utils import synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(card, torch.cuda.device_count(), flush=True)
    ck.build()
    # 4 frames of a scene of chip_smoke.py's kind, and its calib
    scene = synthetic.make_scene(seed=cs.SEED, num_frames=4,
                                 num_landmarks=8000, trajectory="loop",
                                 hw=cs.HW)
    L, _ = synthetic.render_sequence(scene)
    mega = synthetic.megaproblem(scene.calib, cs.MEGA["P"], cs.MEGA["L"],
                                 cs.MEGA["obs_per_lm"], cs.SEED)
    print(cs.nccl_ranks(ck, mega, scene.calib, L, card[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
