function img_out = tom_xmipp_scale_pyramid(img, operation, levels)
%TOM_XMIPP_SCALE_PYRAMID B-spline pyramid 'expand' or 'reduce' by LEVELS.
%Replaces tom_xmipp_scale_pyramid.cpp.
%
%   img_out = tom_xmipp_scale_pyramid(img, operation, levels)
if nargin < 3, levels = 1; end
out = xmipp_matlab_bridge('scale_pyramid', struct('img', img, ...
    'operation', operation, 'levels', levels));
img_out = out.img_out;
end
