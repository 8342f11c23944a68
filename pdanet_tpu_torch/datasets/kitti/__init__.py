"""KITTI: only the numpy rotated IoU of the official evaluation, which the
ONCE evaluation shares, is ported; the KITTI dataset is ROADMAP queue 1
item 8."""
