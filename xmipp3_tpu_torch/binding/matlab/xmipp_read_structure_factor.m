function [f2, logF] = xmipp_read_structure_factor(rundir)
%XMIPP_READ_STRUCTURE_FACTOR read structureFactor.xmd from a
%volume_structure_factor run directory: squared frequency and
%log structure factor. Replaces xmipp_read_structure_factor.cpp.
out = xmipp_matlab_bridge('read_structure_factor', ...
    struct('rundir', rundir));
f2 = out.f2;
logF = out.logF;
end
