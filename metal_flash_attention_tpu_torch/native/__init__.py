"""Native components of the port: the nvcc build of `csrc/*.cu` and the
host-side page allocator."""
