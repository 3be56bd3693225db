"""launches_per_batch: kernel launches the program counted
(sbwt_tpu_torch.kernels.LAUNCHES) over the window, per batch."""


def read(run):
    if run["launches"] is None or not run["batches"]:
        return None
    return sum(run["launches"].values()) / run["batches"]
