"""The plain reference that decides ``correct``.

It reads the FASTA files a job was given and the output file the job
wrote, each with a reader of its own (``fasta``, ``onealn``, ``paf``), and
judges every record by what it says (``judge``): the file's format, the
output filters, the trace, each panel's differences against a plain
edit-distance computation (``editdist``), redundancy, and the homology the
generator put into the pair.  It imports nothing of the program and
nothing of the JAX package.
"""
