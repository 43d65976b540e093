"""Confusion-matrix segmentation evaluator (reference pcdet/utils/metrics.py).

The port's copy of `pcdet_tpu.utils.metrics` (numpy), used by the fork's
BEV segmentation head (`experiments.BEVSegEvalAccumulator`).
"""
import numpy as np


class Evaluator:
    def __init__(self, num_class):
        self.num_class = num_class
        self.confusion_matrix = np.zeros([num_class, num_class])

    def Pixel_Accuracy(self):
        return (np.diag(self.confusion_matrix).sum()
                / self.confusion_matrix.sum())

    def Pixel_Accuracy_Class(self):
        acc = np.diag(self.confusion_matrix) / self.confusion_matrix.sum(axis=1)
        return np.nanmean(acc)

    def Mean_Intersection_over_Union(self):
        return np.nanmean(self.class_iou())

    def Frequency_Weighted_Intersection_over_Union(self):
        freq = (np.sum(self.confusion_matrix, axis=1)
                / np.sum(self.confusion_matrix))
        iu = self.class_iou()
        return (freq[freq > 0] * iu[freq > 0]).sum()

    def class_iou(self):
        gt_count = np.sum(self.confusion_matrix, axis=1)
        pred_count = np.sum(self.confusion_matrix, axis=0)
        tp = np.diag(self.confusion_matrix)
        with np.errstate(divide='ignore', invalid='ignore'):
            return tp / (gt_count + pred_count - tp)

    def _generate_matrix(self, gt_image, pre_image):
        mask = (gt_image >= 0) & (gt_image < self.num_class)
        label = self.num_class * gt_image[mask].astype('int') + pre_image[mask]
        count = np.bincount(label, minlength=self.num_class ** 2)
        return count.reshape(self.num_class, self.num_class)

    def add_batch(self, gt_image, pre_image):
        assert gt_image.shape == pre_image.shape
        self.confusion_matrix += self._generate_matrix(gt_image, pre_image)

    def reset(self):
        self.confusion_matrix = np.zeros((self.num_class,) * 2)
