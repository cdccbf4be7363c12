"""The benchmark of ``epik_tpu_torch``: FASTA to jplace on one card.

``python3 placebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result as
the last line of standard output.
"""
