"""Tutorial 7 on the PyTorch port: tag scenes by logged agent behavior
(u-turns, reversing).

Counterpart of examples/07_behavior_diversity.py and of the reference's
behavior-diversity tutorial (reference:
examples/tutorials/07_agent_behavior_diversity.md +
data_utils/detect_behavior.py): scan a processed-scene directory, count
vehicles whose logged trajectories contain u-turns or sustained reversing,
and print which files to pick for a behavior-diverse training set.  Host
code only (numpy, in worker processes).
"""

import argparse
import os

from gpudrive_lab_torch.data_utils.detect_behavior import process_directory

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenes-dir",
                   default=os.path.join(ROOT, "data", "pool_v3"))
    p.add_argument("--min-reverse-timesteps", type=int, default=10)
    args = p.parse_args()

    stats = process_directory(
        args.scenes_dir, min_reverse_timesteps=args.min_reverse_timesteps
    )
    print(f"vehicles:  {stats['total_agents']}")
    print(f"u-turns:   {stats['total_uturns']} ({stats['uturn_percentage']:.1f}%)")
    print(f"reversing: {stats['total_reversing']} ({stats['reverse_percentage']:.1f}%)")
    print("flagged scenes (use these to diversify a curriculum):")
    for f in stats["flagged_scenes"]:
        print("  ", f)


if __name__ == "__main__":
    main()
