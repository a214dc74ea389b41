"""The ALMA decide loop on torch tensors: telemetry, NB characterization,
cycle fit, Algorithm 2, the LMCM and the fleet simulator."""
