"""The bytes an operation needs, one file an operation
(``bytecount/<op>.py``: ``least_bytes(n, matches)``): each input byte read
once and each output byte written once, whatever the program's kernels
read again or write in between. Over the card's peak bandwidth
(``peaks.json``) it is the least time the operation can take, so it reads
the same whatever kernels implement it."""
