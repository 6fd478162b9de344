from chaorec_tpu_torch.data.loading import DATASET_STATS, RecDataset, data_load  # noqa: F401
