"""TUM RGB-D file formats."""
