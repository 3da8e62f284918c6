r"""Dataset registry of the port: the JAX package's ids, in its order, of the
datasets ported so far. Physics 101 (``P101``), Human3.6M (``H36M``) and
Caltech Pedestrian (``CP``) decode video files, and wait for a video decoder
on the card's machine."""
from vp_suite_tpu_torch.datasets.bair import BAIRPushingDataset
from vp_suite_tpu_torch.datasets.kitti_raw import KITTIRawDataset
from vp_suite_tpu_torch.datasets.kth import KTHActionsDataset
from vp_suite_tpu_torch.datasets.mmnist import MovingMNISTDataset
from vp_suite_tpu_torch.datasets.mmnist_on_the_fly import MovingMNISTOnTheFly
from vp_suite_tpu_torch.datasets.synpick import SynpickMovingDataset

DATASET_CLASSES = {
    "MM": MovingMNISTDataset,
    "MMF": MovingMNISTOnTheFly,
    "BAIR": BAIRPushingDataset,
    "KTH": KTHActionsDataset,
    "SPM": SynpickMovingDataset,
    "KITTI": KITTIRawDataset,
}
AVAILABLE_DATASETS = DATASET_CLASSES.keys()
