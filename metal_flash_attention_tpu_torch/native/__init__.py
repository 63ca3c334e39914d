"""Native components of the port: the nvcc build of `csrc/*.cu` (and its
tile variants), and the host library: the page allocator and the
runtime's config store."""
