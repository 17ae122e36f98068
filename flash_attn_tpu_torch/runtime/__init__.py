"""Host-side runtime pieces of the port: the native page allocator."""
