"""BVH input and output."""
