"""Evaluation loop: counterpart of ``pdanet_tpu/eval/eval_utils.py``
(``tools/eval_utils/eval_utils.py`` :22-144).

``eval_one_epoch`` runs the forward and post-processing of every batch
under ``torch.inference_mode()`` through ``serving.make_predict_fn``,
counts recall on the device with the port's ``boxes_iou3d``, reads each
batch back to the host once, and hands the trimmed per-frame predictions
to the dataset's prediction dicts and official evaluation.  It keeps the
reference's ``--infer_time`` meter (the first 10 % of iterations
skipped) and its ``result.pkl``.  Under ``dist_test`` each process of
a process group evaluates its shard of the frames; the prediction dicts
are merged into dataset order by ``common_utils.merge_results_dist`` and
the recall counters summed over the ranks (JAX :139-158), and rank 0
alone evaluates and writes ``result.pkl``.
"""

import pickle
import time

import numpy as np
import torch

from .. import parallel
from ..models.detectors.iassd import generate_recall_record
from ..serving import make_predict_fn
from ..train.train_utils import select_device_batch
from ..utils.common_utils import merge_results_dist


def statistics_info(cfg, ret_dict, metric, disp_dict):
    for cur_thresh in cfg.MODEL.POST_PROCESSING.RECALL_THRESH_LIST:
        metric["recall_roi_%s" % str(cur_thresh)] += ret_dict.get(
            "roi_%s" % str(cur_thresh), 0
        )
        metric["recall_rcnn_%s" % str(cur_thresh)] += ret_dict.get(
            "rcnn_%s" % str(cur_thresh), 0
        )
    metric["gt_num"] += ret_dict.get("gt", 0)


def _to_host(tensors, device):
    """Copy a dict of device tensors to numpy with one wait for the device
    (bfloat16, which numpy lacks, as float32)."""
    host = {k: (v.float() if v.dtype == torch.bfloat16 else v).to(
        "cpu", non_blocking=True) for k, v in tensors.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {k: v.numpy() for k, v in host.items()}


def eval_one_epoch(cfg, model, dataloader, epoch_id, logger, result_dir,
                   save_to_file=False, infer_time=False, device="cuda", dist_test=False):
    """Evaluate ``model`` on every batch of ``dataloader`` on ``device``;
    returns the recall and the dataset's evaluation as one dict.  With
    ``dist_test`` the loader holds this rank's shard, and ranks other than
    0 return ``{}`` once their predictions are merged."""
    device = torch.device(device)
    model.to(device)
    result_dir.mkdir(parents=True, exist_ok=True)
    final_output_dir = result_dir / "final_result" / "data"
    if save_to_file:
        final_output_dir.mkdir(parents=True, exist_ok=True)

    thresh_list = list(cfg.MODEL.POST_PROCESSING.RECALL_THRESH_LIST)
    metric = {"gt_num": 0}
    for cur_thresh in thresh_list:
        metric["recall_roi_%s" % str(cur_thresh)] = 0
        metric["recall_rcnn_%s" % str(cur_thresh)] = 0

    dataset = dataloader.dataset
    class_names = dataset.class_names
    det_annos = []
    predict = make_predict_fn(model, cfg.MODEL)

    logger.info(f"*************** EPOCH {epoch_id} EVALUATION *****************")
    start_time = time.time()
    infer_time_meter = []
    num_iters = len(dataloader)

    for i, batch_dict in enumerate(dataloader):
        dev_batch = select_device_batch(batch_dict, device, model)
        gt_boxes = dev_batch.pop("gt_boxes", None)
        t0 = time.time()
        pred, out = predict(dev_batch, with_forward=True)
        keys = list(pred)
        if gt_boxes is not None:
            with torch.inference_mode():
                P = pred["pred_boxes"].shape[1]
                pred_valid = (torch.arange(P, device=device)[None, :]
                              < pred["pred_counts"][:, None])
                # a two-stage detector's first-stage proposals give roi_<t>
                rec = generate_recall_record(pred["pred_boxes"], pred_valid,
                                             gt_boxes, thresh_list, out.get("rois"),
                                             out.get("roi_valid"))
                pred.update({"recall/" + k: v.sum() for k, v in rec.items()})
        host = _to_host(pred, device)
        if infer_time and i > num_iters * 0.1:
            infer_time_meter.append(
                (time.time() - t0) * 1000 / batch_dict["batch_size"]
            )
        recall = {k[len("recall/"):]: int(v) for k, v in host.items()
                  if k.startswith("recall/")}
        statistics_info(cfg, recall, metric, {})

        # fixed-size outputs -> trimmed per-frame dicts
        pred = {k: host[k] for k in keys}
        pred_dicts = []
        for b in range(batch_dict["batch_size"]):
            cnt = int(pred["pred_counts"][b])
            pred_dicts.append(
                {
                    "pred_boxes": pred["pred_boxes"][b][:cnt],
                    "pred_scores": pred["pred_scores"][b][:cnt],
                    "pred_labels": pred["pred_labels"][b][:cnt].astype(np.int64),
                }
            )
        annos = dataset.generate_prediction_dicts(
            batch_dict, pred_dicts, class_names,
            output_path=final_output_dir if save_to_file else None,
        )
        det_annos += annos

    if dist_test:
        det_annos = merge_results_dist(det_annos, len(dataset), str(result_dir / "tmpdir"))
        keys = list(metric)
        counts = parallel.all_reduce_detached(
            torch.tensor([metric[k] for k in keys], dtype=torch.int64, device=device))
        metric = dict(zip(keys, counts.tolist()))
        if det_annos is None:
            return {}

    sec_per_example = (time.time() - start_time) / max(len(det_annos), 1)
    logger.info(
        "Generate label finished(sec_per_example: %.4f second)." % sec_per_example
    )
    if infer_time and infer_time_meter:
        logger.info("Average infer time: %.2f ms" % np.mean(infer_time_meter))

    gt_num_cnt = max(metric["gt_num"], 1)
    ret_dict = {}
    for cur_thresh in thresh_list:
        cur_roi_recall = metric["recall_roi_%s" % str(cur_thresh)] / gt_num_cnt
        cur_rcnn_recall = metric["recall_rcnn_%s" % str(cur_thresh)] / gt_num_cnt
        logger.info("recall_roi_%s: %f" % (cur_thresh, cur_roi_recall))
        logger.info("recall_rcnn_%s: %f" % (cur_thresh, cur_rcnn_recall))
        ret_dict["recall/roi_%s" % str(cur_thresh)] = cur_roi_recall
        ret_dict["recall/rcnn_%s" % str(cur_thresh)] = cur_rcnn_recall

    with open(result_dir / "result.pkl", "wb") as f:
        pickle.dump(det_annos, f)

    result_str, result_dict = dataset.evaluation(det_annos, class_names)
    if result_str:
        logger.info(result_str)
    ret_dict.update(result_dict)
    logger.info("Result is saved to %s" % result_dir)
    logger.info("****************Evaluation done.*****************")
    return ret_dict
