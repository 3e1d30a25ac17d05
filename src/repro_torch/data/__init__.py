"""Synthetic tasks, non-IID partitioning and batching (numpy copies of
``repro.data``, so that the port needs nothing of the JAX package)."""
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import (batch_iterator, bucket_size, gather_batch, make_batches, stack_clients,
                                       stack_cohort)
from repro_torch.data.synthetic import SyntheticTask, make_keyword_task
