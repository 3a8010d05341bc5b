function img_out = tom_xmipp_scale(img, outsize, gridding)
%TOM_XMIPP_SCALE resample a 2D image or 3D volume to OUTSIZE
%(B-spline by default, Fourier gridding when GRIDDING is true).
%Replaces tom_xmipp_scale.cpp.
%
%   img_out = tom_xmipp_scale(img, outsize, gridding)
if nargin < 3, gridding = false; end
out = xmipp_matlab_bridge('scale', struct('img', img, ...
    'outsize', outsize, 'gridding', gridding));
img_out = out.img_out;
end
