"""Traffic: ``<name>.json`` parameter files, each read by the generator
module its ``kind`` names."""
