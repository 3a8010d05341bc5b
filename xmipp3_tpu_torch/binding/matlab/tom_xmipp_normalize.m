function img_out = tom_xmipp_normalize(img, method, mask)
%TOM_XMIPP_NORMALIZE normalize with METHOD in 'OldXmipp', 'Near_OldXmipp',
%'NewXmipp', 'NewXmipp2', 'Michael', 'Ramp' (optional background MASK).
%Replaces tom_xmipp_normalize.cpp.
%
%   img_out = tom_xmipp_normalize(img, method, mask)
if nargin < 3, mask = []; end
out = xmipp_matlab_bridge('normalize', struct('img', img, ...
    'method', method, 'mask', mask));
img_out = out.img_out;
end
