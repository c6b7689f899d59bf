"""The training data path: WAV I/O, the dataset on disk, collate, the
bucketed sampler and the prefetching batch manager (numpy on the host)."""
