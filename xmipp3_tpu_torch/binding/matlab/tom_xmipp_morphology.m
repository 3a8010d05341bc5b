function img_out = tom_xmipp_morphology(img, operation, neig, ksize, count)
%TOM_XMIPP_MORPHOLOGY binary 'dilation'/'erosion'/'opening'/'closing' with
%neighbourhood NEIG (2D: 4|8, 3D: 6|18|26), element size KSIZE and the
%reference's count semantics. Replaces tom_xmipp_morphology.cpp.
%
%   img_out = tom_xmipp_morphology(img, operation, neig, ksize, count)
if nargin < 5, count = 0; end
if nargin < 4, ksize = 1; end
if nargin < 3
    if ndims(img) == 2, neig = 8; else neig = 18; end
end
out = xmipp_matlab_bridge('morphology', struct('img', img, ...
    'operation', operation, 'neig', neig, 'ksize', ksize, 'count', count));
img_out = out.img_out;
end
