"""File formats: TUM RGB-D text files, PCD clouds, PLY export."""
