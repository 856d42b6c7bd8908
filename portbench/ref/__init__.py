"""The benchmark's plain reference: minigraph's host path, frozen.

A copy of the port's host-only mapping path (graph reader, minimizer
index, native batch tail and its C sources) taken when the benchmark
was defined, importing nothing of the port.  It maps every read of a
file on the host and returns each read's GAF text, which the harness
holds the port's output to, byte for byte.  At -c a read the native
batch gives up is mapped again by a host finish (finish.py, with frozen
copies of the port's per-read tail and host CIGAR path: chains.py,
cigar.py, wfa.py), as the port maps it again on its per-read path.
"""
