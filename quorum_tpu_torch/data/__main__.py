"""`python -m quorum_tpu_torch.data [out.fa]`: write the built-in
Illumina adapter FASTA and print its path, for `--contaminant` in
quorum and quorum_error_correct_reads."""

import sys

from . import adapter_fasta

if __name__ == "__main__":
    print(adapter_fasta(sys.argv[1] if len(sys.argv) > 1 else None))
