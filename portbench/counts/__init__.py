"""The yardstick's frozen counts: the chip's peaks, and the operations and
bytes that a kernel's call or a model's token needs, from shapes alone."""
