"""KITTI: the dataset (infos, gt database, ``__getitem__`` with the FOV crop
and the road plane, prediction dicts) and the official evaluation in
numpy, whose rotated IoU the ONCE evaluation shares."""
