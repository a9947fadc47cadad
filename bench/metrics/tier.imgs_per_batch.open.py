"""tier.imgs_per_batch.open: images answered over buckets dispatched, from
the tier's ``ServerStats`` over the window."""


def read(run):
    b = run.stats["batches"]
    return run.stats["completed"] / b if b else None
