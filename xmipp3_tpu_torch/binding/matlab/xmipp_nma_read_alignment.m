function [images, NMAdisplacements, cost] = xmipp_nma_read_alignment(NMAdirectory)
%XMIPP_NMA_READ_ALIGNMENT read images.xmd written by the NMA alignment
%programs: image names, per-image normal-mode displacement vectors and
%costs. Replaces xmipp_nma_read_alignment.cpp.
out = xmipp_matlab_bridge('nma_read_alignment', ...
    struct('NMAdirectory', NMAdirectory));
images = out.images;
NMAdisplacements = out.NMAdisplacements;
cost = out.cost;
end
