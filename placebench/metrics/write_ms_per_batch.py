"""Mean time of the jplace writer a batch: the port's
``PipelineStats.write_seconds`` over its ``num_iterations``."""


def read(run):
    if not run.stats.num_iterations:
        return None
    return 1e3 * run.stats.write_seconds / run.stats.num_iterations
