"""Mean time of the port's FASTA reader (``NativeFastaReader.next_batch``,
in ``run_pipeline``'s reader thread) a batch, from the harness's spans."""


def read(run):
    spans = run.spans["read"]
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
