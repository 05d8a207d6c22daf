"""requests_per_pass.reports: requests answered over groups dispatched in
the window, the server's `completed` over its `batches` (host clock): how
full the coalescing windows left for the bind-many passes."""
from bench import stats


def read(run):
    return stats.per_batch(run)
