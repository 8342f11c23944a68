"""ONCE submission packager: ``python -m pdanet_tpu_torch.tools.once_submit_result
--result_pkl <result.pkl> --testset_list <ImageSets/test.txt>``.

A copy of the JAX package's ``tools/once_submit_result.py`` (reference
:1-56): the test CLI's ``result.pkl`` filtered to the test set's frame ids
and to scores above ``--score_thresh``, dumped as the submission pkl."""

import argparse
import pickle

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--result_pkl", type=str, required=True)
    parser.add_argument("--testset_list", type=str, required=True,
                        help="ImageSets/test.txt style frame-id list")
    parser.add_argument("--output", type=str, default="submission.pkl")
    parser.add_argument("--score_thresh", type=float, default=0.2)
    args = parser.parse_args(argv)

    with open(args.result_pkl, "rb") as f:
        results = pickle.load(f)
    with open(args.testset_list) as f:
        test_ids = set(x.strip() for x in f)

    submission = []
    for anno in results:
        if str(anno["frame_id"]) not in test_ids:
            continue
        keep = np.asarray(anno["score"]) > args.score_thresh
        submission.append(
            {
                "frame_id": anno["frame_id"],
                "name": np.asarray(anno["name"])[keep],
                "score": np.asarray(anno["score"])[keep],
                "boxes_3d": np.asarray(anno["boxes_3d"])[keep],
            }
        )
    with open(args.output, "wb") as f:
        pickle.dump(submission, f)
    print(f"wrote {len(submission)} frames to {args.output}")


if __name__ == "__main__":
    main()
